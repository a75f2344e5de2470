"""The port's flow nets against flax: the warp and its grid sampler, the
spatial embedding, the layers whose conventions differ between the two
frameworks, and the whole PINN forward (cascaded flows and pressure) with
the same randomised weights carried across by ``params_from_jax`` (f32,
CPU, the tiny PINN config of tests/test_ukf.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.models import flownet as jax_flownet
from b_pinn_kalman_filter_tpu.models import layers as jax_layers
from b_pinn_kalman_filter_tpu.ops import grid_sample as jax_gs
from b_pinn_kalman_filter_tpu_torch.models import flownet
from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax
from b_pinn_kalman_filter_tpu_torch.ops import grid_sample
from b_pinn_kalman_filter_tpu_torch.pinn import pinn as torch_pinn
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4   # relative to max |reference|, f32


def _close(got, want, tol=TOL):
  want = np.asarray(want)
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  assert got.shape == want.shape, (got.shape, want.shape)
  err = np.abs(got - want).max()
  assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _t(a):
  return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope='module')
def pinn_pair():
  jax_config, torch_config = port_parity.tiny_pinn_configs()
  model = port_parity.jax_pinn(jax_config)
  params = port_parity.randomized_params(port_parity.pinn_param_shapes(
      jax_config))
  port = torch_pinn.PINN(torch_config).eval()
  params_from_jax(params, port)
  return jax.jit(lambda p, *a: model.apply({'params': p}, *a)), params, port


def test_parameter_names_are_the_flax_paths(pinn_pair):
  _, params, port = pinn_pair
  flat = {}

  def walk(tree, prefix=''):
    for k, v in tree.items():
      if isinstance(v, dict):
        walk(v, f'{prefix}{k}.')
      else:
        flat[f'{prefix}{k}'] = np.shape(v)

  walk(params)
  assert flat == {n: tuple(p.shape) for n, p in port.named_parameters()}


def test_pinn_forward_matches_flax(pinn_pair):
  """Both frames, two images with different times: every cascaded flow
  and the pressure."""
  apply, params, port = pinn_pair
  f1, f2, x, y, t = port_parity.pinn_inputs(batch=2)
  flows, pres = apply(params, *map(jnp.asarray, (f1, f2, x, y, t)))
  with torch.inference_mode():
    got_flows, got_pres = port(*map(_t, (f1, f2, x, y, t)))
  assert len(got_flows) == len(flows) == 3
  for g, w in zip(got_flows, flows):
    assert np.abs(np.asarray(w)).max() > 1e-2   # randomised weights
    _close(g, w)
  _close(got_pres, pres)


@pytest.mark.parametrize('padding_mode', ['zeros', 'border'])
@pytest.mark.parametrize('align_corners', [True, False])
def test_grid_sample_matches_jax(padding_mode, align_corners):
  rng = np.random.default_rng(0)
  img = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
  grid = rng.uniform(-1.3, 1.3, (2, 4, 6, 2)).astype(np.float32)
  want = jax_gs.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid),
                               padding_mode, align_corners)
  got = grid_sample.grid_sample_2d(_t(img), _t(grid), padding_mode,
                                   align_corners)
  _close(got, want, 1e-6)
  _close(grid_sample.make_normalized_grid(2, 5, 7),
         jax_gs.make_normalized_grid(2, 5, 7), 1e-6)


def test_project_keeps_the_channel_swap():
  """u[..., 0] moves along y and u[..., 1] along x, each scaled by the
  other axis's size (non-square image, so a swap would show)."""
  rng = np.random.default_rng(1)
  f = rng.standard_normal((1, 6, 9, 2)).astype(np.float32)
  u = rng.standard_normal((1, 6, 9, 2)).astype(np.float32)
  want = jax_flownet.project(jnp.asarray(f), jnp.asarray(u), 0.7)
  _close(flownet.project(_t(f), _t(u), 0.7), want, 1e-6)
  swapped = flownet.project(_t(f), _t(u[..., ::-1].copy()), 0.7)
  assert np.abs(swapped.numpy() - np.asarray(want)).max() > 1e-2


def test_spatial_embedding_takes_the_max_over_the_whole_tensor():
  rng = np.random.default_rng(2)
  x = rng.uniform(0, 1, (2, 4, 4, 1)).astype(np.float32)
  y = rng.uniform(0, 1, (2, 4, 4, 1)).astype(np.float32)
  x[1] *= 0.5      # per-image maxima differ from the tensor's
  want = jax_layers.get_spatial_embedding(jnp.asarray(x), jnp.asarray(y),
                                          100, 100)
  _close(layers.get_spatial_embedding(_t(x), _t(y), 100, 100), want, 1e-5)


@pytest.mark.parametrize('size', [(8, 8), (7, 5), (3, 2)])
def test_resize_bilinear_matches_jax_at_the_borders(size):
  """Up (x2 as in FinalUpsample, and uneven) and down, half-pixel
  centres."""
  rng = np.random.default_rng(3)
  x = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
  want = jax_flownet.resize_bilinear(jnp.asarray(x), size)
  _close(flownet.resize_bilinear(_t(x), size), want, 1e-6)


def _flax_module(module, torch_module, *inputs, seed=4):
  shapes = jax.eval_shape(lambda: module.init(
      jax.random.PRNGKey(0), *map(jnp.asarray, inputs)))['params']
  params = port_parity.randomized_params(shapes, seed)
  want = module.apply({'params': params}, *map(jnp.asarray, inputs))
  params_from_jax(params, torch_module)
  with torch.inference_mode():
    got = torch_module(*map(_t, inputs))
  return got, want


def test_flow_upsample_kernel_is_flipped_for_conv_transpose():
  x = np.random.default_rng(5).standard_normal((1, 3, 4, 2))
  got, want = _flax_module(jax_flownet.FlowUpsample(), flownet.FlowUpsample(),
                           x.astype(np.float32))
  _close(got, want, 1e-5)


def test_pressure_net_conv_transpose_is_flipped():
  import flax.linen as nn
  x = np.random.default_rng(6).standard_normal((1, 3, 4, 5))
  got, want = _flax_module(nn.ConvTranspose(3, (2, 2), strides=(2, 2)),
                           flownet.ConvTranspose(5, 3), x.astype(np.float32))
  _close(got, want, 1e-5)


def test_conv_feature_pads_one_on_both_sides_at_stride_2():
  x = np.random.default_rng(7).standard_normal((1, 8, 6, 2))
  got, want = _flax_module(jax_flownet.ConvFeature(4),
                           flownet.ConvFeature(2, 4), x.astype(np.float32))
  _close(got, want, 1e-5)


def test_unported_flow_models_raise():
  _, config = port_parity.tiny_pinn_configs()
  config.model.arch = 'liteflownet'
  with pytest.raises(NotImplementedError, match='not ported'):
    torch_pinn.get_flow_model(config)
