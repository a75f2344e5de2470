"""DPS and the controlled sampler of the port against the JAX package's,
on the three solvers, and the reference quirks each keeps.

The score model is the flat MLP at 4x4x1, batch 2 (``tests/inverse_parity``)
with the same randomised weights on both sides, the same prior, JAX's
observation noise and JAX's per-t draws fed in through ``noise_at``.
Limits, relative to max |JAX|: 1e-4 in f32 (``fixed``, ``dpm``); the
Dormand–Prince runs in f64 on both sides (``jax.enable_x64`` as a
context), 1e-10, with the NFE and status exact: in f32 the step size
drifts by an ulp (XLA's and PyTorch's ``pow`` differ), which moves the
controlled sampler's noise keys ``int32(t * 1e6)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu.inverse import conditional_sampling as jax_cs
from b_pinn_kalman_filter_tpu.inverse import obsv_sde as jax_obsv
from b_pinn_kalman_filter_tpu.inverse import operators as jax_ops
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.inverse import conditional_sampling as cs
from b_pinn_kalman_filter_tpu_torch.inverse import obsv_sde, operators
from b_pinn_kalman_filter_tpu_torch.models import registry
from tests import inverse_parity as ip
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
F64_TOL = 1e-10
# Few steps keep both runs short.  DPS's RK45 field is stiff near t = T
# (x0_hat divides x by the marginal mean, 0.0066 at the config's
# beta_max 20: 44,311 evaluations on this model), so its RK45 case takes
# beta_max 2 (961).
SOLVERS = {'fixed': dict(inverse=dict(fixed_steps=6)),
           'dpm': dict(inverse=dict(dpm_steps=4)),
           'RK45': dict(model=dict(beta_max=2.0))}


@pytest.fixture(scope='module')
def setup():
  j_config, p_config = ip.mlp_configs()
  j_model, params = ip.jax_model(j_config)
  return dict(j_config=j_config, p_config=p_config, j_model=j_model,
              params=params, p_model=ip.torch_model(p_config, params),
              mask=ip.checkerboard(4, 4))


def _rel(got, want):
  """Max |got - want| over max |want|, in want's precision."""
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _observed(setup, dtype=np.float32):
  """(JAX's observation SDE, the port's) of the MLP configs over the
  checkerboard mask and ``ip.origin()``."""
  x0 = ip.origin().astype(dtype)
  j_op = jax_ops.InpaintOperator(mask=setup['mask'])
  p_op = operators.InpaintOperator(mask=setup['mask'])
  return (jax_obsv.LOBSVSDE(jax_sde.get_sde(setup['j_config'])[0],
                            j_op(jnp.asarray(x0), keep_shape=False), j_op),
          obsv_sde.LOBSVSDE(sde_lib.get_sde(setup['p_config'])[0],
                            p_op(torch.tensor(x0), keep_shape=False), p_op))


def _configure(setup, sampler, solver):
  for config in (setup['j_config'], setup['p_config']):
    config.inverse.sampler = sampler
    config.inverse.solver = solver
    config.model.beta_max = 20.
    for block, values in SOLVERS.get(solver, {}).items():
      config[block].update(values)


def _run(setup, sampler, solver, seed, monkeypatch):
  """(JAX's sample, JAX's Dormand–Prince result or None, the port's
  sample, the port's info) from JAX key ``seed``: the same prior, JAX's
  observation noise (DPS) or per-t draws (controlled).  JAX's sampler runs
  unjitted (its loop compiled by ``lax``) so that its ``odeint_dopri``
  result can be read."""
  _configure(setup, sampler, solver)
  j_obsv, p_obsv = _observed(
      setup, np.float64 if solver == 'RK45' else np.float32)
  rng = jax.random.PRNGKey(seed)
  z, obs_noise, third = ip.jax_draws(rng, ip.SHAPE, p_obsv.y0.shape)
  results = []
  dopri = jax_cs.ode_lib.odeint_dopri

  def recorded(*args, **kwargs):
    results.append(dopri(*args, **kwargs))
    return results[-1]

  monkeypatch.setattr(jax_cs.ode_lib, 'odeint_dopri', recorded)
  j_fn = jax_cs.get_sampler(setup['j_config'], j_obsv, ip.SHAPE, eps=ip.EPS)
  want = j_fn(rng, setup['j_model'], setup['params'],
              z=jnp.asarray(z.numpy()))
  p_fn = cs.get_sampler(setup['p_config'], p_obsv, ip.SHAPE, eps=ip.EPS,
                        device='cpu')
  kw = (dict(obs_noise=obs_noise) if sampler == 'dps'
        else dict(noise_at=ip.jax_noise_at(third, ip.SHAPE)))
  info = {}
  got = p_fn(setup['p_model'], None, z=z, info=info, **kw)
  return np.asarray(want), (results or [None])[0], got, info


def check_sampler_matches_jax(setup, sampler, solver, monkeypatch):
  with jax.enable_x64(solver == 'RK45'):
    want, result, got, info = _run(setup, sampler, solver, 3, monkeypatch)
  assert got.shape == ip.SHAPE and torch.isfinite(got).all()
  assert got.dtype == (torch.float64 if solver == 'RK45' else torch.float32)
  assert _rel(got.numpy(), want) <= (F64_TOL if solver == 'RK45' else TOL)
  if solver == 'RK45':
    assert info == {'nfe': int(result.nfe), 'status': int(result.status)}
    assert info['status'] == 0 and info['nfe'] > 60
  else:
    assert info == {'nfe': {'fixed': 6, 'dpm': 5}[solver]}


@pytest.mark.parametrize('solver', ['fixed', 'dpm'])
@pytest.mark.parametrize('sampler', ['dps', 'controlled'])
def test_sampler_matches_jax(setup, sampler, solver, monkeypatch):
  """(The RK45 cases are in tests/test_torch_inverse_ops.py, which has
  the time to spare.)"""
  check_sampler_matches_jax(setup, sampler, solver, monkeypatch)


def _linear_score(c):
  """score(x, t) = c x, whose Tweedie estimate and guidance have closed
  forms."""
  return lambda x, t: c * x


def test_dps_guidance_closed_form():
  """With score = c x, x0_hat = k x with k = 1/mean + std^2 c (the std^2
  term NOT divided by mean: the reference's Tweedie quirk), and the
  guidance is 2 k A^T(y - A k x) / (var * ||y - A k x||), the norm taken
  ONCE over the whole batch."""
  sde = sde_lib.VPSDE()
  mask = torch.tensor(ip.checkerboard(4, 4))
  op = operators.InpaintOperator(mask=mask)
  x = torch.tensor(ip.origin(seed=5))
  y = op(torch.tensor(ip.origin(seed=6)), keep_shape=False)
  t = torch.full((2,), 0.4)
  c, var = -1.7, 0.1
  score, score_cond = cs.dps_guidance(sde, _linear_score(c), y, op, var)(x, t)
  mean, std = (float(v[0]) for v in sde.marginal_coef(t))
  k = 1.0 / mean + std ** 2 * c
  diff = y - op(k * x, keep_shape=False)
  diff_img = op.project_observed(diff, (4, 4))
  want = 2 * k * diff_img / (var * torch.linalg.vector_norm(diff))
  torch.testing.assert_close(score_cond, want, rtol=1e-5, atol=1e-6)
  torch.testing.assert_close(score, c * x)


def test_dps_guidance_couples_the_batch():
  """Moving sample 1 rescales sample 0's guidance by the ratio of the
  batch norms: per-sample norms would leave it unchanged."""
  sde = sde_lib.VPSDE()
  op = operators.InpaintOperator(mask=ip.checkerboard(4, 4))
  y = op(torch.tensor(ip.origin(seed=6)), keep_shape=False)
  guidance = cs.dps_guidance(sde, _linear_score(-1.0), y, op, 0.1)
  t = torch.full((2,), 0.4)
  x = torch.tensor(ip.origin(seed=5))
  moved = x.clone()
  moved[1] += 3.0
  _, before = guidance(x, t)
  _, after = guidance(moved, t)
  mean, std = (float(v[0]) for v in sde.marginal_coef(t))
  k = 1.0 / mean - std ** 2

  def norm(v):
    return torch.linalg.vector_norm(y - op(k * v, keep_shape=False))

  assert not torch.allclose(after[0], before[0])
  torch.testing.assert_close(after[0], before[0] * norm(x) / norm(moved),
                             rtol=1e-5, atol=1e-6)


def test_dps_observation_noise_on_live_rows_only():
  mask = ip.checkerboard(4, 4)
  op = operators.InpaintOperator(mask=mask)
  y0 = op(torch.tensor(ip.origin()), keep_shape=False)
  obsv = obsv_sde.LOBSVSDE(sde_lib.VPSDE(), y0, op)
  noise = torch.ones_like(y0)
  got = cs.noisy_observation(obsv, noise, 0.25)
  live = torch.tensor(mask.reshape(1, 1, -1)).expand_as(y0) > 0
  torch.testing.assert_close(got[live], y0[live] + 0.5)
  assert torch.equal(got[~live], torch.zeros_like(got[~live]))


def test_dps_uses_the_continuous_score_and_detached_parameters(
    setup, monkeypatch):
  """``nc_ddpmpp`` trains with ``continuous=False``; DPS still takes the
  continuous score, under parameters that do not require grad (so the
  backward computes no weight gradient), with x requiring it."""
  _configure(setup, 'dps', 'fixed')
  setup['p_config'].inverse.fixed_steps = 2
  assert setup['p_config'].training.continuous is False
  calls, seen = [], []
  get_score_fn = registry.get_score_fn

  def recorded(*args, **kwargs):
    calls.append(kwargs)
    return get_score_fn(*args, **kwargs)

  def hook(module, args):
    seen.append((args[0].requires_grad, module.Dense_0.kernel.requires_grad))

  monkeypatch.setattr(registry, 'get_score_fn', recorded)
  model = setup['p_model']
  assert all(p.requires_grad for p in model.parameters())
  handle = model.register_forward_pre_hook(hook)
  try:
    _, p_obsv = _observed(setup)
    cs.get_dps_sampler(setup['p_config'], p_obsv, ip.SHAPE, device='cpu')(
        model, None, generator=torch.Generator().manual_seed(0))
  finally:
    handle.remove()
  assert calls[0]['continuous'] is True
  assert seen == [(True, False)] * 2


def test_fixed_solver_dt_is_not_the_grid_spacing():
  """``dt = -2e-5 * 5000 / fixed_steps``: any step count integrates 0.1
  time units of drift, and the grid still spans t1 .. eps; as JAX's
  ``_solve``."""
  config = ip.mlp_configs()[1]
  x0 = torch.ones((2, 3))
  ts = []

  def field(t, x):
    ts.append(float(t))
    return torch.ones_like(x)

  for solver, steps in (('fixed', 50), ('Fixed', 7)):
    config.inverse.solver, config.inverse.fixed_steps = solver, steps
    ts.clear()
    out = cs._solve(config, field, x0, 1.0, 1e-3)
    want = jax_cs._solve(config, lambda t, x: jnp.ones_like(x),
                         jnp.asarray(x0.numpy()), 1.0, 1e-3)
    assert _rel(out.numpy(), want) <= TOL
    torch.testing.assert_close(out, torch.full((2, 3), 0.9))
    assert len(ts) == steps and ts[0] == 1.0 and ts[-1] == np.float32(1e-3)
  config.inverse.solver = 'euler'
  with pytest.raises(NotImplementedError):
    cs._solve(config, field, x0, 1.0, 1e-3)


def test_controlled_returns_the_raw_ode_state(setup):
  """Two ``fixed`` steps (t = 1, then eps; dt = -0.05): each moves the
  state by the drift taken at the projected point x_hat, and the sample
  is the state, not a projection of it."""
  _configure(setup, 'controlled', 'fixed')
  config = setup['p_config']
  config.inverse.fixed_steps = 2
  _, p_obsv = _observed(setup)
  z = torch.tensor(ip.origin(seed=8))
  noise = torch.tensor(ip.origin(seed=9))
  got = cs.get_controlled_sampler(config, p_obsv, ip.SHAPE,
                                  lambda t: (1.0 - t) * 0.8, device='cpu')(
      setup['p_model'], None, z=z, noise_at=lambda t: noise)
  op, sde = p_obsv.operator, p_obsv.state_sde
  score_fn = registry.get_score_fn(sde, setup['p_model'], continuous=True)
  x = z
  with torch.no_grad():
    for t in (1.0, np.float32(ip.EPS)):
      vec_t = torch.full((2,), float(t))
      w = (1.0 - float(t)) * 0.8
      y_img = op.project_observed(p_obsv.observe_sampling(noise, vec_t),
                                  (4, 4))
      x_hat = w * y_img + (1 - w) * op.mask * x + (1 - op.mask) * x
      x = x + sde.reverse(score_fn, True).sde(x_hat, vec_t)[0] * -0.05
  torch.testing.assert_close(got, x)
  assert not torch.allclose(got, x_hat, atol=1e-3)
