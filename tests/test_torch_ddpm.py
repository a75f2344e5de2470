"""The port's DDPM U-Net against the flax DDPM, with the same randomised
weights carried across by ``params_from_jax`` (f32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch.models import ddpm as torch_ddpm
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope='module')
def models():
  jax_config, torch_config = port_parity.tiny_configs()
  flax_apply, params = port_parity.jax_tiny_model(jax_config)
  port = torch_ddpm.DDPM(torch_config)
  params_from_jax(params, port)
  return flax_apply, params, port.eval(), torch_config


def test_forward_matches_flax(models):
  flax_apply, params, port, config = models
  rng = np.random.default_rng(1)
  x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
  labels = np.asarray([13.7, 981.2], np.float32)   # t * 999
  want = np.asarray(flax_apply(params, jnp.asarray(x), jnp.asarray(labels)))
  with torch.inference_mode():
    got = port(torch.from_numpy(x), torch.from_numpy(labels),
               train=False).numpy()
  assert got.shape == want.shape
  scale = np.abs(want).max()
  assert scale > 1e-2          # randomised weights: the output is not ~0
  # Error <= 1e-4 relative to max |y|, as tests/test_winograd.py holds the
  # model-level Winograd swap.
  assert np.abs(got - want).max() / scale <= 1e-4


def test_parameter_names_are_the_flax_paths(models):
  _, params, port, _ = models

  def paths(tree, prefix=''):
    for k, v in tree.items():
      if isinstance(v, dict):
        yield from paths(v, f'{prefix}{k}.')
      else:
        yield f'{prefix}{k}', np.shape(v)

  assert dict(paths(params)) == {n: tuple(p.shape)
                                 for n, p in port.named_parameters()}


def test_stray_leaf_raises(models):
  _, params, port, _ = models
  bad = dict(params)
  bad['Dense_9'] = {'kernel': np.zeros((1, 1), np.float32)}
  with pytest.raises(ValueError, match='Dense_9.kernel'):
    params_from_jax(bad, port)


def test_missing_leaf_raises(models):
  _, params, port, _ = models
  bad = dict(params)
  bad['ResnetBlockDDPM_0'] = dict(bad['ResnetBlockDDPM_0'])
  del bad['ResnetBlockDDPM_0']['Dense_0']
  with pytest.raises(ValueError, match='ResnetBlockDDPM_0.Dense_0.kernel'):
    params_from_jax(bad, port)


def test_wrong_shape_raises(models):
  _, params, port, _ = models
  bad = dict(params)
  bad['Dense_0'] = {'kernel': np.zeros((3, 3), np.float32),
                    'bias': params['Dense_0']['bias']}
  with pytest.raises(ValueError, match='Dense_0.kernel'):
    params_from_jax(bad, port)


def test_kernel_sites_are_the_jax_ones(models):
  """Counted the way chip_smoke.py counts launches: per forward, 2 GroupNorm
  +SiLU per resblock, and the 3x3 convs that pass the JAX guard (all but
  the first and last)."""
  _, _, port, config = models
  from b_pinn_kalman_filter_tpu_torch.models import layers
  from b_pinn_kalman_filter_tpu_torch.ops import conv3x3
  blocks = [m for m in port.modules()
            if isinstance(m, layers.ResnetBlockDDPM)]
  convs = [m for m in port.modules() if isinstance(m, layers.Conv3x3)
           and m.kernels and conv3x3.applicable(
               (0, 0, 0, m.Conv_0.kernel.shape[2]), m.Conv_0.kernel.shape)]
  fused = [m for m in port.modules() if isinstance(m, layers.GroupNorm)
           and m.act is not None and m.kernels]
  # 1 block per level down (2), 2 middle, 2 per level up (4); 1 Upsample.
  assert len(blocks) == 8
  assert len(fused) == 2 * len(blocks)
  assert len(convs) == 2 * len(blocks) + 1


def test_small_layers_match_flax():
  """The layers off the kernel sites that the U-Net test reaches only in
  part: Conv1x1, and the timestep embedding at an odd width."""
  import jax
  from b_pinn_kalman_filter_tpu.models import layers as jax_layers
  from b_pinn_kalman_filter_tpu_torch.models import layers
  rng = np.random.default_rng(2)
  x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
  flax_conv = jax_layers.Conv1x1(16)
  params = port_parity.randomized_params(jax.eval_shape(
      lambda: flax_conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))['params'])
  want = flax_conv.apply({'params': params}, jnp.asarray(x))
  conv = layers.Conv1x1(8, 16)
  params_from_jax(params, conv)
  with torch.inference_mode():
    got = conv(torch.from_numpy(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)

  t = np.asarray([0.0, 13.7, 981.2], np.float32)
  want = jax_layers.get_timestep_embedding(jnp.asarray(t), 33)
  got = layers.get_timestep_embedding(torch.from_numpy(t), 33)
  # sin/cos of arguments up to ~1e3, where one f32 ulp of the argument is
  # 6e-5: the two libraries' argument reductions may differ by that much.
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
