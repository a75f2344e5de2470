"""Conditional samplers for inverse problems: the projection-controlled
probability-flow sampler and diffusion posterior sampling (DPS).

Counterpart of the JAX package's ``inverse/conditional_sampling.py``.
Both integrate the conditional probability-flow ODE with the score network
inside its right-hand side, by Dormand–Prince (``'RK45'``/``'RK23'``), the
``'fixed'`` Euler loop or the guided DPM-Solver++ (``'dpm'``).  DPS takes
the data-fidelity gradient through the score network with
``torch.autograd.grad`` on every evaluation; the parameters are detached
there, so the backward computes the data gradient only.

Randomness: the prior comes from ``generator`` (or ``z``), DPS's
observation noise too (or ``obs_noise``, a standard normal of the
observation's shape).  The controlled sampler draws fresh noise for each
time t, keyed by a base seed from ``generator`` and ``int32(t * 1e6)`` as
JAX folds it into its key, so that the same t (a rejected Dormand–Prince
step's, say) gives the same noise; ``noise_at(t)`` replaces those draws.
A sampler called with ``info``, a dict, records its ``nfe`` (and for
Dormand–Prince its ``status``) there.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.core import ode as ode_lib
from b_pinn_kalman_filter_tpu_torch.core import sampling as sampling_lib
from b_pinn_kalman_filter_tpu_torch.core.sde import batch_mul
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.inverse.obsv_sde import OBSVSDE
from b_pinn_kalman_filter_tpu_torch.inverse.operators import InpaintOperator
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils


def _record(info: Optional[dict], **values) -> None:
  if info is not None:
    info.update(values)


def _solve(config, ode_func, x0, t1, eps, info=None):
  """Integrate ``ode_func(t, x)`` from ``t1`` to ``eps`` with the config's
  solver.  ``'RK45'``/``'RK23'`` (any case): Dormand–Prince at rtol = atol
  = 1e-3 and up to 100,000 steps.  ``'fixed'``: ``inverse.fixed_steps``
  (default 5000) Euler steps over ``linspace(t1, eps)`` with ``dt =
  -2e-5 * 5000 / fixed_steps``, which is not the grid's spacing: the
  reference's 0.1 time units of drift at any step count."""
  solver = config.inverse.solver
  if solver.upper() in ('RK45', 'RK23'):
    result = ode_lib.odeint_dopri(ode_func, x0, t1, eps, rtol=1e-3,
                                  atol=1e-3, max_steps=100_000)
    _record(info, nfe=result.nfe, status=result.status)
    return result.y
  elif solver.lower() == 'fixed':
    n_steps = int(config.inverse.get('fixed_steps', 5000))
    dt = -2e-5 * (5000.0 / n_steps)
    x = x0
    for t in ode_lib.linspace(t1, eps, n_steps):
      x = x + ode_func(t, x) * dt
    _record(info, nfe=n_steps)
    return x
  raise NotImplementedError(
      f"solver {solver!r} unknown (RK45/RK23/fixed here; 'dpm' is handled "
      'inside the samplers themselves)')


def _dpm_solve(config, sde, x, x0_fn, eps, info):
  """The guided DPM-Solver++ over the effective data prediction
  ``x0_fn``, ending on its prediction at ``eps`` (``dpm_steps`` + 1
  evaluations)."""
  x, nfe = sampling_lib.dpm_multistep_solve(
      sde, x, x0_fn, steps=int(config.inverse.get('dpm_steps', 50)),
      order=int(config.inverse.get('dpm_order', 2)),
      skip_type=config.inverse.get('dpm_skip', 'logsnr'), eps=eps,
      denoise=True)
  _record(info, nfe=nfe)
  return x


def t_key(t) -> int:
  """``int32(t * 1e6)`` in t's precision (f64 for an f64 scalar, else
  f32): the data JAX folds into the noise key."""
  s = np.float64 if np.asarray(t).dtype == np.float64 else np.float32
  return int(s(t) * s(1e6))


def keyed_noise(shape, generator: Optional[torch.Generator], device
                ) -> Callable:
  """``noise_at(t)``: a standard normal of ``shape`` on ``device`` from a
  generator seeded by a base seed (one draw from ``generator``) and
  :func:`t_key` of t."""
  base = int(torch.randint(2 ** 31 - 1, (1,), generator=generator,
                           device=device).item())

  def noise_at(t):
    g = torch.Generator(device=device).manual_seed(
        (base << 32) | (t_key(t) & 0xFFFFFFFF))
    return torch.randn(shape, generator=g, device=device)

  return noise_at


def _prior(sde, shape, generator, z, device):
  return (sde.prior_sampling(shape, generator=generator, device=device)
          if z is None else z.to(device))


def get_sampler(config, obsv_sde: OBSVSDE, shape,
                lambda_schedule: Callable = lambda t: (1.0 - t) * 0.8,
                eps: float = 1e-3, device=None):
  """The sampler of ``inverse.sampler``: ``fn(model, params=None, **kw)
  -> samples``."""
  if config.inverse.sampler == 'controlled':
    return get_controlled_sampler(config, obsv_sde, shape, lambda_schedule,
                                  eps=eps, device=device)
  elif config.inverse.sampler == 'dps':
    return get_dps_sampler(config, obsv_sde, shape, eps=eps, device=device)
  raise NotImplementedError


def get_controlled_sampler(config, obsv_sde: OBSVSDE, shape, lambda_schedule,
                           eps: float = 1e-3, device=None):
  """Projection-controlled probability-flow sampler:
  ``fn(model, params=None, *, generator=None, z=None, noise_at=None,
  info=None) -> samples``.

  Each evaluation first mixes the state with a fresh observation sample,
  x_hat = w L^T A y_t + (1 - w) A x + (I - A) x with w = lambda(t), then
  takes the reverse-ODE drift at x_hat.  As in the reference, the sample
  returned is the raw ODE state: the projection moves only the drift's
  evaluation point.  ``'dpm'`` integrates the same field as
  DPM-Solver++(2M) through the effective score s_eff = score(x_hat) -
  2 (f(x_hat) - f(x)) / g^2, and returns its last data prediction.
  """
  device = get_device(device)
  shape = tuple(shape)
  H, W = shape[1], shape[2]
  state_sde = obsv_sde.state_sde
  op = obsv_sde.operator
  if not isinstance(op, InpaintOperator):
    raise TypeError('controlled sampler currently supports inpainting '
                    'operators')

  def optimize_fn(zr, x, t):
    y_img = op.project_observed(obsv_sde.observe_sampling(zr, t), (H, W))
    weight = lambda_schedule(t)[:, None, None, None]
    return weight * y_img + (1.0 - weight) * op.mask * x + (1.0 - op.mask) * x

  def controlled_sampler(model, params: Optional[Dict] = None, *,
                         generator: Optional[torch.Generator] = None,
                         z: Optional[torch.Tensor] = None,
                         noise_at: Optional[Callable] = None,
                         info: Optional[dict] = None):
    score_fn = mutils.get_score_fn(state_sde, model, train=False,
                                   continuous=True, params=params)
    rsde = state_sde.reverse(score_fn, probability_flow=True)
    with torch.no_grad():
      x = _prior(state_sde, shape, generator, z, device)
      if noise_at is None:
        noise_at = keyed_noise(shape, generator, device)

      dtype = x.dtype

      def vec(t):
        return torch.full((shape[0],), float(t), dtype=dtype, device=device)

      if config.inverse.solver.lower() == 'dpm':

        def x0_eff_fn(xt, t):
          vec_t = vec(t)
          x_hat = optimize_fn(noise_at(t).to(device), xt, vec_t)
          score = score_fn(x_hat, vec_t)
          f_x, g = state_sde.sde(xt, vec_t)
          f_hat, _ = state_sde.sde(x_hat, vec_t)
          s_eff = score - batch_mul(2.0 / g ** 2, f_hat - f_x)
          mean, std = state_sde.marginal_coef(vec_t)
          return batch_mul(1.0 / mean, xt + batch_mul(std ** 2, s_eff))

        return _dpm_solve(config, state_sde, x, x0_eff_fn, eps, info)

      def ode_func(t, x):
        vec_t = vec(t)
        x_hat = optimize_fn(noise_at(t).to(device), x, vec_t)
        return rsde.sde(x_hat, vec_t)[0]

      return _solve(config, ode_func, x, state_sde.T, eps, info)

  return controlled_sampler


def dps_guidance(sde, score_fn, observation, operator, obsv_var):
  """``guidance(x, t) -> (score, score_cond)``: the score at x and the
  gradient in x of -||y - A x0_hat||^2 / var divided by the norm, with
  the reference's Tweedie estimate x0_hat = x / mean + std^2 score (the
  std^2 term not divided by mean) and ONE norm over the whole batch, so
  the samples of a batch are coupled.  The gradient goes through the
  score network; each call's graph is released when it returns."""

  def guidance(x, vec_t):
    with torch.enable_grad():
      xt = x.detach().requires_grad_(True)
      score = score_fn(xt, vec_t)
      mean, std = sde.marginal_coef(vec_t)
      x0_hat = batch_mul(1.0 / mean, xt) + batch_mul(std ** 2, score)
      difference = observation - operator(x0_hat, keep_shape=False)
      norm = torch.linalg.vector_norm(difference)
      grad, = torch.autograd.grad(-norm ** 2 / obsv_var, xt)
    return score.detach(), grad / norm.detach()

  return guidance


def noisy_observation(obsv_sde: OBSVSDE, obs_noise, variance: float):
  """y0 plus ``sqrt(variance)`` times the standard normal ``obs_noise`` on
  the live rows of the observation only: the reference's compacted
  observation has no rows where the zero-padded one is structurally 0."""
  y0 = obsv_sde.y0
  noise = obs_noise.to(y0.device) * variance ** 0.5
  return y0 + noise * obsv_sde.operator.observation_mask(y0)


def get_dps_sampler(config, obsv_sde: OBSVSDE, shape, eps: float = 1e-3,
                    device=None):
  """Diffusion posterior sampling: ``fn(model, params=None, *,
  generator=None, z=None, obs_noise=None, info=None) -> samples``.

  The observation is :func:`noisy_observation` at
  ``inverse.variance``.  The
  field is the conditional probability-flow ODE, drift f(x) - g^2 (score
  + score_cond) / 2, with the continuous-time score whatever the config's
  ``training.continuous``.  ``'dpm'`` integrates it through the effective
  data prediction (x + std^2 (score + score_cond)) / mean and returns its
  last prediction; the other solvers return the ODE state at eps.
  """
  device = get_device(device)
  shape = tuple(shape)
  obsv_var = config.inverse.variance
  sde = obsv_sde.state_sde
  operator = obsv_sde.operator

  def dps_sampler(model, params: Optional[Dict] = None, *,
                  generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None,
                  obs_noise: Optional[torch.Tensor] = None,
                  info: Optional[dict] = None):
    # Parameters that do not require grad: the guidance's backward then
    # computes no weight gradient.
    if params is None:
      params = dict(model.named_parameters())
    params = {k: v.detach() for k, v in params.items()}
    score_fn = mutils.get_score_fn(sde, model, train=False, continuous=True,
                                   params=params)
    with torch.no_grad():
      x = _prior(sde, shape, generator, z, device)
      if obs_noise is None:
        obs_noise = torch.randn(obsv_sde.y0.shape, generator=generator,
                                device=device)
      observation = noisy_observation(obsv_sde, obs_noise, obsv_var)
      guidance = dps_guidance(sde, score_fn, observation, operator, obsv_var)

      dtype = x.dtype

      def vec(t):
        return torch.full((shape[0],), float(t), dtype=dtype, device=device)

      if config.inverse.solver.lower() == 'dpm':

        def x0_eff_fn(xt, t):
          vec_t = vec(t)
          score, score_cond = guidance(xt, vec_t)
          mean, std = sde.marginal_coef(vec_t)
          x0_true = batch_mul(1.0 / mean, xt + batch_mul(std ** 2, score))
          return x0_true + batch_mul(std ** 2 / mean, score_cond)

        return _dpm_solve(config, sde, x, x0_eff_fn, eps, info)

      def ode_func(t, x):
        vec_t = vec(t)
        score, score_cond = guidance(x, vec_t)
        drift, diffusion = sde.sde(x, vec_t)
        return drift - batch_mul(diffusion ** 2, score + score_cond) * 0.5

      return _solve(config, ode_func, x, sde.T, eps, info)

  return dps_sampler
