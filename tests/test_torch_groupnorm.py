"""Kernel K2 (GroupNorm+act): the port's plain version against the JAX
package's Pallas kernel (interpret mode).  The CUDA kernel against the plain
version: tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.ops.groupnorm_pallas import groupnorm_act
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from tests.port_parity import one_torch_thread  # noqa: F401


# The tolerance tests/test_groupnorm_pallas.py holds the kernel to in f32.
TOL = 2e-5


def _inputs(shape, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal(shape).astype(np.float32)
  scale = rng.standard_normal(shape[-1]).astype(np.float32)
  bias = rng.standard_normal(shape[-1]).astype(np.float32)
  return x, scale, bias


@pytest.mark.parametrize('act', ['silu', 'none'])
def test_plain_matches_pallas_interpret(act):
  x, scale, bias = _inputs((2, 8, 8, 128))
  want = groupnorm_act(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                       num_groups=32, act=act, interpret=True)
  with torch.inference_mode():
    got = k2.groupnorm_act(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), num_groups=32, act=act)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                             atol=TOL)


def test_default_device_raises_without_cuda():
  if torch.cuda.is_available():
    assert get_device().type == 'cuda'
  else:
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      get_device()


def test_no_fallback_off_cpu():
  x = torch.empty((1, 4, 4, 32), device='meta')
  s = torch.empty((32,), device='meta')
  with pytest.raises(ValueError, match='no kernel for device'):
    k2.groupnorm_act(x, s, s)


def test_forward_only_raises_under_grad():
  """No longer forward only: under autograd the wrapper's gradients are
  those of autograd through the plain version."""
  x, scale, bias = _inputs((1, 4, 4, 32))
  args = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
  y = k2.groupnorm_act(*args)
  assert y.grad_fn is not None
  got = torch.autograd.grad(y.square().sum(), args)
  plain = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
  want = torch.autograd.grad(
      k2.groupnorm_act_plain(*plain).square().sum(), plain)
  for g, w in zip(got, want):
    assert torch.equal(g, w)


@pytest.mark.parametrize('act', ['silu', 'none'])
def test_backward_matches_jax_custom_vjp(act):
  """dx, dscale and dbias against ``jax.vjp`` of the JAX kernel's
  custom_vjp (interpret mode, C = 128), f32, 1e-4 relative to max |JAX
  gradient|."""
  x, scale, bias = _inputs((2, 8, 8, 128), seed=1)
  dy = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
  _, vjp = jax.vjp(lambda *a: groupnorm_act(*a, num_groups=32, act=act,
                                            interpret=True),
                   jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
  want = vjp(jnp.asarray(dy))
  args = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
  got = torch.autograd.grad(k2.groupnorm_act(*args, num_groups=32, act=act),
                            args, torch.from_numpy(dy))
  for g, w in zip(got, want):
    w = np.asarray(w)
    assert g.shape == w.shape
    assert np.abs(g.numpy() - w).max() / np.abs(w).max() <= 1e-4


def test_forward_mode_on_the_cpu_matches_jax_jvp():
  """A forward-mode tangent in x, scale and bias takes the plain version on
  the CPU and carries it: ``torch.func.jvp`` equals ``jax.jvp`` of the JAX
  reference GroupNorm+SiLU (what the Pallas kernel computes; the kernel's
  own custom_vjp has no forward mode).  On the card the wrapper refuses
  such a tensor (tests/test_torch_kernels_cuda.py) until the kernel has a
  forward-mode rule (ROADMAP.md B.3)."""
  from b_pinn_kalman_filter_tpu.ops.groupnorm_pallas import (
      _reference_groupnorm_act)
  primals = _inputs((2, 4, 4, 64), seed=3)
  tangents = _inputs((2, 4, 4, 64), seed=4)

  def jax_fn(x, scale, bias):
    return _reference_groupnorm_act(x, scale, bias, 32, 'silu', 1e-6)

  def port_fn(x, scale, bias):
    return k2.groupnorm_act(x, scale, bias, 32, 'silu', 1e-6)

  want_y, want_t = jax.jvp(jax_fn, tuple(map(jnp.asarray, primals)),
                           tuple(map(jnp.asarray, tangents)))
  got_y, got_t = torch.func.jvp(port_fn, tuple(map(torch.from_numpy, primals)),
                                tuple(map(torch.from_numpy, tangents)))
  for got, want in ((got_y, want_y), (got_t, want_t)):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(want)).max())
