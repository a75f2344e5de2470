"""Kernel K1 (3x3 conv): the port's plain version against the JAX package's
Pallas Winograd kernel (interpret mode) and direct conv.  The CUDA kernel
against the plain version: tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.ops import winograd as wg
from b_pinn_kalman_filter_tpu.ops import winograd_pallas as wp
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from tests.port_parity import one_torch_thread  # noqa: F401


# The tolerance tests/test_winograd.py holds the Pallas kernel to in f32.
TOL = 2e-5


def _inputs(B, H, W, Cin, Cout, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((B, H, W, Cin)).astype(np.float32)
  w = (0.1 * rng.standard_normal((3, 3, Cin, Cout))).astype(np.float32)
  b = rng.standard_normal(Cout).astype(np.float32)
  return x, w, b


def _port(x, w, b):
  with torch.inference_mode():
    return k1.conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b)).numpy()


def test_plain_matches_pallas_winograd_interpret():
  x, w, b = _inputs(1, 8, 8, 128, 128)
  U = wg.transform_kernel(jnp.asarray(w)).reshape(16, 128, 128)
  want = wp.winograd_conv3x3_fused(jnp.asarray(x), U, jnp.asarray(b),
                                   interpret=True)
  np.testing.assert_allclose(_port(x, w, b), np.asarray(want),
                             rtol=TOL, atol=TOL)


def test_plain_matches_direct_conv_at_odd_shape():
  x, w, b = _inputs(1, 7, 9, 32, 48, seed=1)
  want = jax.lax.conv_general_dilated(
      jnp.asarray(x), jnp.asarray(w), (1, 1), 'SAME',
      dimension_numbers=('NHWC', 'HWIO', 'NHWC')) + b
  np.testing.assert_allclose(_port(x, w, b), np.asarray(want),
                             rtol=TOL, atol=TOL)


def test_plain_bf16_matches_jax_direct_conv_semantics():
  """bf16 in and out with f32 accumulation, as JAX ``_direct_conv``."""
  x, w, b = _inputs(1, 4, 4, 32, 32, seed=2)
  want = wg._direct_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                         jnp.asarray(b))
  with torch.inference_mode():
    got = k1.conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                     torch.from_numpy(b))
  assert got.dtype == torch.bfloat16
  want = np.asarray(want.astype(jnp.float32))
  # Both round the same f32 sums to bf16; sums taken in another order may
  # round to the neighbouring bf16 value (one bf16 ulp is 2^-8 relative).
  np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                             atol=2 ** -7)


@pytest.mark.parametrize('x_shape,k_shape', [
    ((1, 8, 8, 128), (3, 3, 128, 256)),
    ((1, 8, 8, 3), (3, 3, 3, 128)),
    ((1, 8, 8, 128), (3, 3, 128, 3)),
    ((1, 8, 8, 32), (3, 3, 32, 32)),
    ((1, 8, 8, 31), (3, 3, 31, 64)),
])
def test_applicable_is_the_jax_guard(x_shape, k_shape):
  assert k1.applicable(x_shape, k_shape) == wg.winograd_applicable(
      x_shape, k_shape)


def test_forward_only_raises_under_grad():
  x, w, b = _inputs(1, 4, 4, 32, 32)
  kernel = torch.from_numpy(w).requires_grad_()
  with pytest.raises(RuntimeError, match='training slice'):
    k1.conv3x3(torch.from_numpy(x), kernel, torch.from_numpy(b))


def test_no_fallback_off_cpu():
  """A tensor on neither the CPU nor a card raises; it is never sent to
  the plain version."""
  x = torch.empty((1, 4, 4, 32), device='meta')
  w = torch.empty((3, 3, 32, 32), device='meta')
  with pytest.raises(ValueError, match='no kernel for device'):
    k1.conv3x3(x, w)
