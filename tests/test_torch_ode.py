"""The port's ODE integrators, DPM-Solver++ core and the PC predictors and
correctors against the JAX package's, on analytic fields and scores.

Limits, relative to max |JAX|: 1e-5 for the integrators and the DPM
schedule in f32 (a few ulps of rounding a step); 1e-10 in f64 (the stiff
field magnifies rounding ~100-fold over its steps); 1e-5 for
one predictor or corrector update; NFE and status exactly.  Where an
accept/reject decision of Dormand–Prince sits near its threshold both
sides run in f64 (``jax.enable_x64`` as a context, so the
worker's later files keep f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.core import ode as jax_ode
from b_pinn_kalman_filter_tpu.core import sampling as jax_sampling
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu_torch.core import ode
from b_pinn_kalman_filter_tpu_torch.core import sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from tests.port_parity import one_torch_thread  # noqa: F401

F32_TOL = 1e-5
F64_TOL = 1e-10
A = np.array([[-0.5, 2.0, 0.0], [-2.0, -0.5, 0.3], [0.0, -0.3, -1.0]])


def _rel(got, want):
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _linear(lib, dtype):
  a = lib.asarray(A.astype(dtype)) if lib is jnp else torch.tensor(
      A.astype(dtype))
  return lambda t, y: y @ a.T


def _stiff(lib):
  """y' = -30 (y - cos(5 t)) + sin(t): its first steps are rejected."""
  if lib is jnp:
    return lambda t, y: -30.0 * (y - jnp.cos(5.0 * t)) + jnp.sin(t)
  return lambda t, y: (-30.0 * (y - torch.cos(torch.as_tensor(5.0 * t)))
                       + torch.sin(torch.as_tensor(t)))


def _y0(dtype):
  return np.random.default_rng(0).standard_normal((4, 3)).astype(dtype)


def test_dopri_linear_f32():
  y0 = _y0(np.float32)
  want = jax_ode.odeint_dopri(_linear(jnp, np.float32), jnp.asarray(y0),
                              0.0, 2.0, rtol=1e-4, atol=1e-6)
  got = ode.odeint_dopri(_linear(torch, np.float32), torch.tensor(y0),
                         0.0, 2.0, rtol=1e-4, atol=1e-6)
  assert (got.nfe, got.status) == (int(want.nfe), int(want.status))
  assert got.nfe > 20 and got.status == 0
  assert _rel(got.y, want.y) <= F32_TOL


@pytest.mark.parametrize('max_steps, t1', [(5000, 1.0), (7, 1.0),
                                           (5000, -0.5)])
def test_dopri_rejecting_field_f64(max_steps, t1):
  """A field whose first steps are rejected, forwards and backwards in t,
  and ``max_steps`` running out (status 1), in f64 on both sides."""
  y0 = _y0(np.float64)
  with jax.enable_x64(True):
    want = jax_ode.odeint_dopri(_stiff(jnp), jnp.asarray(y0), 0.0, t1,
                                rtol=1e-7, atol=1e-9, max_steps=max_steps)
    want = jax.tree_util.tree_map(np.asarray, want)
  got = ode.odeint_dopri(_stiff(torch), torch.tensor(y0), 0.0, t1,
                         rtol=1e-7, atol=1e-9, max_steps=max_steps)
  assert (got.nfe, got.status) == (int(want.nfe), int(want.status))
  assert got.status == (1 if max_steps == 7 else 0)
  assert _rel(got.y, want.y) <= F64_TOL


def test_dopri_rejects_steps():
  """The stiff field's first step is rejected: the next step's first
  stage comes before the rejected one's (same t, smaller h), and every
  step, rejected or not, costs six evaluations."""
  y0 = torch.tensor(_y0(np.float64))
  evals = []

  def counted(t, y):
    evals.append(float(t))
    return _stiff(torch)(t, y)

  result = ode.odeint_dopri(counted, y0, 0.0, 1.0, rtol=1e-7, atol=1e-9)
  assert result.nfe == len(evals)
  starts = evals[1::6]
  assert (len(evals) - 1) % 6 == 0 and starts[1] < starts[0]


@pytest.mark.parametrize('method, n', [('rk4', 7), ('euler', 9)])
def test_fixed_grid_f32(method, n):
  y0 = _y0(np.float32)
  jax_fn = getattr(jax_ode, f'odeint_{method}')
  port_fn = getattr(ode, f'odeint_{method}')
  want, want_nfe = jax_fn(_linear(jnp, np.float32), jnp.asarray(y0), 1.0,
                          0.1, n)
  got, nfe = port_fn(_linear(torch, np.float32), torch.tensor(y0), 1.0, 0.1,
                     n)
  assert nfe == int(want_nfe) == {'rk4': 4 * n, 'euler': n}[method]
  assert _rel(got, want) <= F32_TOL


@pytest.mark.parametrize('skip', ['logsnr', 'time'])
@pytest.mark.parametrize('sde_name', ['VPSDE', 'subVPSDE', 'VESDE'])
def test_dpm_schedule(skip, sde_name):
  eps = 1e-5 if sde_name == 'VESDE' else 1e-3
  want = jax_sampling.dpm_schedule(getattr(jax_sde, sde_name)(), 12, skip,
                                   eps)
  got = sampling.dpm_schedule(getattr(sde_lib, sde_name)(), 12, skip, eps)
  for name, g, w in zip(('ts', 'alphas', 'sigmas', 'lams'), got, want):
    assert _rel(g.numpy(), w) <= F32_TOL, name
  assert float(got[0][0]) == 1.0 and float(got[0][-1]) == np.float32(eps)


def test_interp_matches_jnp_interp():
  xp = np.sort(np.random.default_rng(1).random(50)).astype(np.float32)
  fp = np.random.default_rng(2).random(50).astype(np.float32)
  x = np.concatenate([[-1.0, xp[0], xp[-1], 2.0], xp[3:7],
                      np.random.default_rng(3).random(20)]).astype(np.float32)
  want = np.asarray(jnp.interp(x, xp, fp))
  got = sampling.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp))
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


MU0, S0 = 0.8, 0.3


def _x0_pred(lib, sde):
  """The exact data prediction of a Gaussian N(MU0, S0^2) data set."""

  def fn(x, t):
    vec = (jnp.full((x.shape[0],), t) if lib is jnp
           else torch.full((x.shape[0],), float(t)))
    a, s = sde.marginal_coef(vec)
    var = a ** 2 * S0 ** 2 + s ** 2
    score = -(x - (a * MU0)[:, None, None, None]) / var[:, None, None, None]
    return (x + (s ** 2)[:, None, None, None] * score) / a[:, None, None, None]

  return fn


@pytest.mark.parametrize('order, skip, denoise', [(1, 'logsnr', True),
                                                  (2, 'logsnr', True),
                                                  (2, 'time', False)])
def test_dpm_multistep_solve(order, skip, denoise):
  x = np.random.default_rng(4).standard_normal((3, 4, 4, 1)).astype(
      np.float32)
  want, want_nfe = jax_sampling.dpm_multistep_solve(
      jax_sde.VPSDE(), jnp.asarray(x), _x0_pred(jnp, jax_sde.VPSDE()),
      steps=6, order=order, skip_type=skip, denoise=denoise)
  got, nfe = sampling.dpm_multistep_solve(
      sde_lib.VPSDE(), torch.tensor(x), _x0_pred(torch, sde_lib.VPSDE()),
      steps=6, order=order, skip_type=skip, denoise=denoise)
  assert nfe == int(want_nfe) == 6 + denoise
  assert _rel(got, want) <= F32_TOL


def _score(lib, sde):
  def score_fn(x, t):
    a, std = sde.marginal_coef(t)
    var = a ** 2 * S0 ** 2 + std ** 2
    return -(x - (a * MU0)[:, None, None, None]) / var[:, None, None, None]
  return score_fn


def _normals(rng, shape, n):
  keys = jax.random.split(rng, n) if n > 1 else [rng]
  return [torch.from_numpy(np.array(jax.random.normal(k, shape)))
          for k in keys]


@pytest.mark.parametrize('sde_name', ['VPSDE', 'VESDE'])
@pytest.mark.parametrize('kind, name', [
    ('predictor', 'reverse_diffusion'), ('predictor', 'ancestral_sampling'),
    ('corrector', 'langevin'), ('corrector', 'ald')])
def test_predictors_and_correctors(kind, name, sde_name):
  """One update of each on the analytic score, with JAX's own draws fed
  in (two corrector steps: ``split(rng, 2)``)."""
  shape = (3, 4, 4, 2)
  x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
  t = np.array([0.9, 0.5, 0.02], np.float32)
  j_sde = getattr(jax_sde, sde_name)(N=50)
  p_sde = getattr(sde_lib, sde_name)(N=50)
  rng = jax.random.PRNGKey(3)
  jax_fn = getattr(jax_sampling, f'get_{kind}')(name)
  port_fn = getattr(sampling, f'get_{kind}')(name)
  if kind == 'predictor':
    want = jax_fn(rng, jnp.asarray(x), jnp.asarray(t), j_sde,
                  _score(jnp, j_sde), False)
    draws = iter(_normals(rng, shape, 1))
    got = port_fn(torch.tensor(x), torch.tensor(t), p_sde,
                  _score(torch, p_sde), False, lambda: next(draws))
  else:
    want = jax_fn(rng, jnp.asarray(x), jnp.asarray(t), j_sde,
                  _score(jnp, j_sde), 0.16, 2)
    draws = iter(_normals(rng, shape, 2))
    got = port_fn(torch.tensor(x), torch.tensor(t), p_sde,
                  _score(torch, p_sde), 0.16, 2, lambda: next(draws))
  for g, w, what in zip(got, want, ('x', 'x_mean')):
    assert _rel(g.numpy(), w) <= F32_TOL, what
