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
  """No longer forward only: under autograd the wrapper gives the plain
  version's forward and the gradients of autograd through it."""
  x, w, b = _inputs(1, 4, 4, 32, 32)
  args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
  y = k1.conv3x3(*args)
  assert y.grad_fn is not None
  got = torch.autograd.grad(y.square().sum(), args)
  plain = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
  want = torch.autograd.grad(k1.conv3x3_plain(*plain).square().sum(), plain)
  for g, w_ in zip(got, want):
    np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-5, atol=1e-5)


# Gradients, relative to max |JAX gradient|: f32, 1e-4.
GRAD_TOL = 1e-4


@pytest.mark.parametrize('shape', [(2, 8, 8, 32, 48), (1, 5, 7, 40, 32)])
def test_backward_matches_jax_vjp_of_direct_conv(shape):
  """dx by the flipped-kernel conv, dW and db, against ``jax.vjp`` of
  ``winograd._direct_conv`` (the backward of JAX ``_fused_conv``)."""
  x, w, b = _inputs(*shape, seed=3)
  dy = np.random.default_rng(4).standard_normal(
      shape[:3] + (shape[4],)).astype(np.float32)
  _, vjp = jax.vjp(wg._direct_conv, jnp.asarray(x), jnp.asarray(w),
                   jnp.asarray(b))
  want = vjp(jnp.asarray(dy))
  args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
  got = torch.autograd.grad(k1.conv3x3(*args), args, torch.from_numpy(dy))
  for g, w_ in zip(got, want):
    w_ = np.asarray(w_)
    assert g.shape == w_.shape and g.dtype == torch.float32
    assert np.abs(g.numpy() - w_).max() / np.abs(w_).max() <= GRAD_TOL


def test_flipped_kernel_is_the_data_gradient_formula():
  """W'[kh,kw,co,ci] = W[2-kh,2-kw,ci,co], element by element."""
  w = torch.arange(3 * 3 * 2 * 5, dtype=torch.float32).reshape(3, 3, 2, 5)
  f = k1.flipped(w)
  assert f.shape == (3, 3, 5, 2)
  for kh, kw, co, ci in np.ndindex(3, 3, 5, 2):
    assert f[kh, kw, co, ci] == w[2 - kh, 2 - kw, ci, co]


def test_backward_keeps_the_dtypes():
  """bf16 x: dx in bf16, the f32 kernel's and bias's gradients in f32."""
  x, w, b = _inputs(1, 4, 4, 32, 32, seed=5)
  xb = torch.from_numpy(x).bfloat16().requires_grad_()
  wt, bt = (torch.from_numpy(a).requires_grad_() for a in (w, b))
  y = k1.conv3x3(xb, wt, bt)
  assert y.dtype == torch.bfloat16
  dx, dw, db = torch.autograd.grad(y.float().sum(), (xb, wt, bt))
  assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.float32,
                                            torch.float32)


def test_no_fallback_off_cpu():
  """A tensor on neither the CPU nor a card raises; it is never sent to
  the plain version."""
  x = torch.empty((1, 4, 4, 32), device='meta')
  w = torch.empty((3, 3, 32, 32), device='meta')
  with pytest.raises(ValueError, match='no kernel for device'):
    k1.conv3x3(x, w)


def test_forward_mode_on_the_cpu_matches_jax_jvp():
  """A forward-mode tangent in x, the kernel and the bias goes through
  K1's forward-mode rule, the plain version on the CPU, and is carried: ``torch.func.jvp`` equals
  ``jax.jvp`` of the JAX direct conv (the function K1 computes).  On the
  card the same rule launches K1 on each tangent
  (tests/test_torch_kernels_cuda.py); tests/test_torch_jvp.py takes each
  tangent alone."""
  primals = _inputs(1, 5, 6, 8, 16, seed=7)
  tangents = _inputs(1, 5, 6, 8, 16, seed=8)
  want_y, want_t = jax.jvp(wg._direct_conv, tuple(map(jnp.asarray, primals)),
                           tuple(map(jnp.asarray, tangents)))
  got_y, got_t = torch.func.jvp(k1.conv3x3,
                                tuple(map(torch.from_numpy, primals)),
                                tuple(map(torch.from_numpy, tangents)))
  for got, want in ((got_y, want_y), (got_t, want_t)):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(want)).max())
