"""Kernel K4 (one Navier–Stokes step): the port's plain version against the
JAX package's XLA composition and its Pallas kernel (interpret mode), on
the CPU.  The CUDA kernel against the plain version:
tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.ops import ns_step as jax_ns
from b_pinn_kalman_filter_tpu.ops.ns_step_pallas import ns_step_fused
from b_pinn_kalman_filter_tpu_torch.ops import ns_step as k4
from tests.port_parity import one_torch_thread  # noqa: F401

DT, DX = 0.0025, 1 / 200
# Relative to max |reference|: the same f32 operations in the same order,
# up to the two libraries' rounding of divisions by a scalar.
TOL = 1e-5


def _fields(shape, seed=0, still=True):
  rng = np.random.default_rng(seed)
  d = rng.random(shape).astype(np.float32)
  u = (0.2 * rng.standard_normal(shape)).astype(np.float32)
  v = (0.2 * rng.standard_normal(shape)).astype(np.float32)
  p = (0.05 * rng.standard_normal(shape)).astype(np.float32)
  if still:   # u = v = 0 in a corner: the sign(0) = +1 upwind side
    u[:, :shape[1] // 2, :shape[2] // 3] = 0
    v[:, :shape[1] // 2, :shape[2] // 3] = 0
  return d, u, v, p


def _close(got, want):
  for g, w in zip(got, want):
    w = np.asarray(w)
    assert g.shape == w.shape
    assert np.abs(g.numpy() - w).max() <= TOL * np.abs(w).max()


@pytest.fixture(scope='module')
def fields():
  return _fields((3, 16, 12))


def test_plain_matches_jax_composition(fields):
  want = jax_ns.ns_step(*map(jnp.asarray, fields), DT, DX)
  with torch.inference_mode():
    got = k4.ns_step_fused(*map(torch.from_numpy, fields), DT, DX)
  _close(got, want)


def test_plain_matches_pallas_interpret(fields):
  want = ns_step_fused(*map(jnp.asarray, fields), DT, DX, interpret=True)
  with torch.inference_mode():
    got = k4.ns_step(*map(torch.from_numpy, fields), DT, DX)
  _close(got, want)


@pytest.mark.parametrize('name', ['gradient', 'update_velocity',
                                  'update_pressure', 'update_density'])
def test_stages_match_jax(name, fields):
  d, u, v, p = fields
  args = {'gradient': (d, DX), 'update_velocity': (u, v, p, DT, DX),
          'update_pressure': (u, v, p, DT, DX),
          'update_density': (d, u, v, DT, DX)}[name]
  to_jax = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
  to_torch = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args]
  want = getattr(jax_ns, name)(*to_jax)
  got = getattr(k4, name)(*to_torch)
  if name in ('update_pressure', 'update_density'):
    want, got = (want,), (got,)
  _close(got, want)


def test_sign_zero_is_plus_one():
  """u = 0 takes the u > 0 side: the CIP cubic divides by sign(u) dx^3, so
  sign(0) = 0 would give 0/0.  Every x term of the step is multiplied by
  X = -u dt, so at u = 0 the result is the limit from either side."""
  d, _, v, _ = _fields((1, 6, 6), seed=3, still=False)
  dens = torch.from_numpy(d)
  grads = k4.gradient(dens, DX)
  vel = torch.from_numpy(v)

  def step(u_value):
    u = torch.full_like(dens, u_value)
    return k4.cip_advect(dens, *grads, u, vel, DT, DX)

  at_zero = step(0.0)
  assert torch.isfinite(at_zero).all()
  assert (at_zero - dens).abs().max() > 1e-3      # v moves the field
  for side in (1e-30, -1e-30):
    torch.testing.assert_close(at_zero, step(side), rtol=0, atol=1e-6)


def test_wrapper_refuses_gradients_and_other_devices():
  d = torch.zeros((1, 4, 4), requires_grad=True)
  with pytest.raises(RuntimeError, match='training slice'):
    k4.ns_step_fused(d, d, d, d, DT, DX)
  m = torch.empty((1, 4, 4), device='meta')
  with pytest.raises(ValueError, match='no kernel for device'):
    k4.ns_step_fused(m, m, m, m, DT, DX)
