"""The port's FIR ops (``ops/upfirdn2d.py``, ``ops/resample.py``,
``ops/fused_act.py``) against the JAX package's, in f32 on the CPU, on
the same numpy inputs: ``upfirdn2d`` and its literal reference against
JAX's, up and down, positive and negative padding, separable and 2-D
kernels, odd and even sizes; the FIR and nearest resampling, the fused
transposed and strided convs (JAX's ``conv_transpose`` with
``transpose_kernel=False``), ``resample.Conv2d`` and the fused bias
activations.  Limit: 1e-4 of max |JAX|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.ops import fused_act as jax_act
from b_pinn_kalman_filter_tpu.ops import resample as jax_resample
from b_pinn_kalman_filter_tpu.ops import upfirdn2d as jax_fir
from b_pinn_kalman_filter_tpu_torch.ops import fused_act, resample, upfirdn2d
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4


def _x(shape, seed=0):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def _close(got, want):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want)
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= TOL * np.abs(want).max()


KERNELS = {'1331': (1, 3, 3, 1), 'box2': (1, 1), '2d': ((1., 2., 1.),
                                                        (0., 1., 3.),
                                                        (2., 1., 1.))}


@pytest.mark.parametrize('up,down,pad,size', [
    (1, 1, (1, 1), 7), (2, 1, (2, 1), 8), (1, 2, (1, 1), 7),
    (2, 2, (1, 2), 8), (1, 1, (-1, 2), 8), (2, 1, (-1, -1), 7),
    (3, 1, (2, 0), 8)])
@pytest.mark.parametrize('kernel', list(KERNELS))
def test_upfirdn2d_matches_the_reference_and_jax(up, down, pad, size,
                                                 kernel):
  k = upfirdn2d.setup_kernel(KERNELS[kernel])
  np.testing.assert_array_equal(k, jax_fir.setup_kernel(KERNELS[kernel]))
  x = _x((2, size, size + 1, 3))
  got = upfirdn2d.upfirdn2d(torch.from_numpy(x), k, up=up, down=down,
                            pad=pad)
  ref = upfirdn2d.upfirdn2d_ref(torch.from_numpy(x), k, up, up, down, down,
                                pad[0], pad[1], pad[0], pad[1])
  want = jax_fir.upfirdn2d(jnp.asarray(x), jnp.asarray(k), up=up, down=down,
                           pad=pad)
  _close(got, want)
  _close(ref, want)


@pytest.mark.parametrize('k', [None, (1, 3, 3, 1)])
@pytest.mark.parametrize('size', [5, 8])
def test_fir_resampling_matches_jax(k, size):
  x = _x((2, size, size, 4), 1)
  xt, xj = torch.from_numpy(x), jnp.asarray(x)
  _close(resample.upsample_2d(xt, k, factor=2, gain=1.5),
         jax_resample.upsample_2d(xj, k, factor=2, gain=1.5))
  _close(resample.downsample_2d(xt, k, factor=2),
         jax_resample.downsample_2d(xj, k, factor=2))
  _close(resample.naive_upsample_2d(xt, 2),
         jax_resample.naive_upsample_2d(xj, 2))
  if size % 2 == 0:
    _close(resample.naive_downsample_2d(xt, 2),
           jax_resample.naive_downsample_2d(xj, 2))


@pytest.mark.parametrize('conv', [1, 3])
@pytest.mark.parametrize('size', [5, 8])
def test_fused_resampling_convs_match_jax(conv, size):
  """The transposed conv correlates with ``w`` as it stands; a flipped or
  channel-swapped kernel (``F.conv_transpose2d``'s) would miss by O(1)."""
  x = _x((2, size, size, 4), 2)
  w = _x((conv, conv, 4, 6), 3)
  xt, xj = torch.from_numpy(x), jnp.asarray(x)
  wt, wj = torch.from_numpy(w), jnp.asarray(w)
  _close(resample.upsample_conv_2d(xt, wt, (1, 3, 3, 1)),
         jax_resample.upsample_conv_2d(xj, wj, (1, 3, 3, 1)))
  _close(resample.conv_downsample_2d(xt, wt, (1, 3, 3, 1)),
         jax_resample.conv_downsample_2d(xj, wj, (1, 3, 3, 1)))


@pytest.mark.parametrize('mode', ['up', 'down', 'none'])
def test_conv2d_module_matches_jax(mode):
  x = _x((2, 8, 8, 4), 4)
  up, down = mode == 'up', mode == 'down'
  ref = jax_resample.Conv2d(6, kernel=3, up=up, down=down)
  shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0), jnp.asarray(x))
  params = {k: _x(v.shape, 5 + i) for i, (k, v) in
            enumerate(sorted(shapes['params'].items()))}
  want = ref.apply({'params': params}, jnp.asarray(x))
  module = resample.Conv2d(4, 6, 3, up=up, down=down)
  with torch.no_grad():
    for name, p in module.named_parameters():
      p.copy_(torch.from_numpy(params[name]))
  _close(module(torch.from_numpy(x)), want)


def test_fused_activations_match_jax():
  x, b = _x((2, 4, 4, 5), 6), _x((5,), 7)
  xt, bt = torch.from_numpy(x), torch.from_numpy(b)
  _close(fused_act.fused_leaky_relu(xt, bt),
         jax_act.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
  for act in ('linear', 'relu', 'lrelu'):
    _close(fused_act.fused_bias_act(xt, bt, act, 0.1, 2.0),
           jax_act.fused_bias_act(jnp.asarray(x), jnp.asarray(b), act, 0.1,
                                  2.0))
  module = fused_act.FusedLeakyReLU(5)
  assert [n for n, _ in module.named_parameters()] == ['bias']
  with torch.no_grad():
    module.bias.copy_(bt)
  _close(module(xt), jax_act.FusedLeakyReLU(5).apply(
      {'params': {'bias': jnp.asarray(b)}}, jnp.asarray(x)))
  with pytest.raises(NotImplementedError):
    fused_act.fused_bias_act(xt, bt, 'gelu')


def test_fir_weights_made_in_inference_mode_serve_autograd():
  """The depthwise weight is cached a kernel, width and dtype: one first
  made under ``torch.inference_mode`` (a sampler) is still one that
  autograd may save (a train step)."""
  x = torch.from_numpy(_x((1, 4, 4, 7), 8))
  with torch.inference_mode():
    want = resample.upsample_2d(x, (1, 3, 3, 1))
  xg = x.clone().requires_grad_()
  y = resample.upsample_2d(xg, (1, 3, 3, 1))
  (g,) = torch.autograd.grad(y.sum(), xg)
  assert torch.equal(y.detach(), want) and g.shape == x.shape
