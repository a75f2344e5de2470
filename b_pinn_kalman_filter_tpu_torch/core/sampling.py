"""Predictor–corrector sampler in PyTorch.

Counterpart of the JAX package's ``core/sampling.py``: the predictors
(``euler_maruyama``, ``reverse_diffusion``, ``ancestral_sampling``,
``none``) and correctors (``langevin``, ``ald``, ``none``), the PC
sampler, DPM-Solver++ (``dpm_schedule``, ``dpm_multistep_solve`` and its
samplers) and the probability-flow ODE sampler, with ``get_sampling_fn``'s
``pc``, ``dpm_solver`` and ``ode`` branches.

Where JAX scans the N steps as one program, this is a loop on the host
that launches each step's kernels in turn.  Randomness comes from a
``torch.Generator``, or from an explicit noise source so that a test can
feed in the numbers another implementation drew.  The PC sampler runs
under ``torch.inference_mode()``; ``dpm_multistep_solve`` does not, because
the guided inverse samplers take gradients inside its data prediction.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.core import ode as ode_lib
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.core.sde import batch_mul
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils

_PREDICTORS = {}
_CORRECTORS = {}


def register_predictor(fn=None, *, name: str = None):
  """Register a predictor update function."""

  def _register(fn):
    local_name = fn.__name__ if name is None else name
    if local_name in _PREDICTORS:
      raise ValueError(f'Already registered predictor with name: {local_name}')
    _PREDICTORS[local_name] = fn
    return fn

  return _register if fn is None else _register(fn)


def register_corrector(fn=None, *, name: str = None):
  """Register a corrector update function."""

  def _register(fn):
    local_name = fn.__name__ if name is None else name
    if local_name in _CORRECTORS:
      raise ValueError(f'Already registered corrector with name: {local_name}')
    _CORRECTORS[local_name] = fn
    return fn

  return _register if fn is None else _register(fn)


def get_predictor(name: str):
  return _PREDICTORS[name]


def get_corrector(name: str):
  return _CORRECTORS[name]


# ---------------------------------------------------------------------------
# Predictors: (x, t, sde, score_fn, probability_flow, draw) -> (x, x_mean)
# Correctors: (x, t, sde, score_fn, snr, n_steps, draw) -> (x, x_mean)
# ``draw()`` returns the next standard normal of x's shape.
# ---------------------------------------------------------------------------

@register_predictor(name='euler_maruyama')
def euler_maruyama_predictor(x, t, sde, score_fn, probability_flow, draw):
  """Euler–Maruyama on the reverse SDE."""
  rsde = sde.reverse(score_fn, probability_flow)
  dt = -1.0 / rsde.N
  z = draw()
  drift, diffusion = rsde.sde(x, t)
  x_mean = x + drift * dt
  x = x_mean + batch_mul(diffusion, float(np.sqrt(-dt)) * z)
  return x, x_mean


@register_predictor(name='reverse_diffusion')
def reverse_diffusion_predictor(x, t, sde, score_fn, probability_flow, draw):
  """Reverse-diffusion discretization."""
  rsde = sde.reverse(score_fn, probability_flow)
  f, G = rsde.discretize(x, t)
  z = draw()
  x_mean = x - f
  x = x_mean + batch_mul(G, z)
  return x, x_mean


@register_predictor(name='ancestral_sampling')
def ancestral_sampling_predictor(x, t, sde, score_fn, probability_flow, draw):
  """Ancestral sampling for the VE and VP SDEs."""
  if probability_flow:
    raise ValueError('Probability flow not supported by ancestral sampling')
  timestep = sde_lib._timestep(sde, t)
  noise = draw()
  if isinstance(sde, sde_lib.VESDE):
    sigmas = sde.discrete_sigmas.to(t.device)
    sigma = sigmas[timestep]
    adjacent_sigma = torch.where(timestep == 0, torch.zeros_like(t),
                                 sigmas[torch.clamp(timestep - 1, min=0)])
    score = score_fn(x, t)
    x_mean = x + batch_mul(sigma ** 2 - adjacent_sigma ** 2, score)
    std = torch.sqrt(adjacent_sigma ** 2 * (sigma ** 2 - adjacent_sigma ** 2)
                     / sigma ** 2)
    return x_mean + batch_mul(std, noise), x_mean
  if isinstance(sde, sde_lib.VPSDE):
    beta = sde.discrete_betas.to(t.device)[timestep]
    score = score_fn(x, t)
    x_mean = batch_mul(1.0 / torch.sqrt(1.0 - beta),
                       x + batch_mul(beta, score))
    return x_mean + batch_mul(torch.sqrt(beta), noise), x_mean
  raise NotImplementedError(
      f'SDE class {sde.__class__.__name__} not yet supported.')


@register_predictor(name='none')
def none_predictor(x, t, sde, score_fn, probability_flow, draw):
  return x, x


def _corrector_alpha(sde, t):
  """``sde.alphas[timestep]`` for VP and sub-VP (the upstream step size),
  else ones."""
  if isinstance(sde, (sde_lib.VPSDE, sde_lib.subVPSDE)):
    return sde.alphas.to(t.device)[sde_lib._timestep(sde, t)]
  return torch.ones_like(t)


def _mean_norm(v):
  """Mean over the batch of each sample's L2 norm."""
  return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()


@register_corrector(name='langevin')
def langevin_corrector(x, t, sde, score_fn, snr, n_steps, draw):
  """SNR-scaled Langevin MCMC corrector."""
  alpha = _corrector_alpha(sde, t)
  x_mean = x
  for _ in range(n_steps):
    grad = score_fn(x, t)
    noise = draw()
    step_size = (snr * _mean_norm(noise) / _mean_norm(grad)) ** 2 * 2 * alpha
    x_mean = x + batch_mul(step_size, grad)
    x = x_mean + batch_mul(torch.sqrt(step_size * 2), noise)
  return x, x_mean


@register_corrector(name='ald')
def ald_corrector(x, t, sde, score_fn, snr, n_steps, draw):
  """Annealed Langevin dynamics (the NCSN corrector)."""
  alpha = _corrector_alpha(sde, t)
  std = sde.marginal_prob(x, t)[1]
  x_mean = x
  for _ in range(n_steps):
    grad = score_fn(x, t)
    noise = draw()
    step_size = (snr * std) ** 2 * 2 * alpha
    x_mean = x + batch_mul(step_size, grad)
    x = x_mean + batch_mul(torch.sqrt(step_size * 2), noise)
  return x, x_mean


@register_corrector(name='none')
def none_corrector(x, t, sde, score_fn, snr, n_steps, draw):
  return x, x


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def get_sampling_fn(config, sde, model, shape, inverse_scaler, eps,
                    device=None) -> Callable:
  """Build a sampling function from config:
  ``sampling_fn(generator=None, noise=None, params=None) -> (samples,
  nfe)``."""
  sampler_name = config.sampling.method.lower()
  if sampler_name == 'ode':
    return get_ode_sampler(sde=sde, model=model, shape=shape,
                           inverse_scaler=inverse_scaler,
                           denoise=config.sampling.noise_removal, eps=eps,
                           device=device)
  elif sampler_name == 'dpm_solver':
    return get_dpm_solver_sampler(
        sde=sde, model=model, shape=shape, inverse_scaler=inverse_scaler,
        steps=config.sampling.get('dpm_steps', 20),
        order=config.sampling.get('dpm_order', 2),
        skip_type=config.sampling.get('dpm_skip', 'logsnr'),
        continuous=config.training.continuous,
        denoise=config.sampling.noise_removal, eps=eps, device=device)
  elif sampler_name == 'pc':
    return get_pc_sampler(
        sde=sde, model=model, shape=shape,
        predictor=get_predictor(config.sampling.predictor.lower()),
        corrector=get_corrector(config.sampling.corrector.lower()),
        inverse_scaler=inverse_scaler, snr=config.sampling.snr,
        n_steps=config.sampling.n_steps_each,
        probability_flow=config.sampling.probability_flow,
        continuous=config.training.continuous,
        denoise=config.sampling.noise_removal, eps=eps, device=device)
  else:
    raise ValueError(f"Sampler name {sampler_name} unknown.")


def get_pc_sampler_from_score(sde, shape: Sequence[int], predictor,
                              corrector, inverse_scaler, snr,
                              n_steps: int = 1,
                              probability_flow: bool = False,
                              denoise: bool = True, eps: float = 1e-3,
                              device=None) -> Callable:
  """PC sampler taking an explicit score function:
  ``fn(score_fn, generator=None, noise=None) -> (samples, nfe)``.

  ``noise``, when given, replaces the generator: an iterable whose first
  tensor is the prior sample x_T and whose next tensors are the standard
  normals the predictor and corrector draw, in the order they draw them
  (for ``euler_maruyama`` with corrector ``none``: one z per step).
  The result is the inverse-scaled last ``x_mean`` (``denoise``) or ``x``.
  """
  device = get_device(device)
  shape = tuple(shape)
  # The JAX grid jnp.linspace(T, eps, N), as f32 host scalars.
  timesteps = np.linspace(sde.T, eps, sde.N).astype(np.float32)

  def pc_sampler(score_fn, generator: Optional[torch.Generator] = None,
                 noise: Optional[Iterable[torch.Tensor]] = None):
    with torch.inference_mode():
      if noise is None:
        x = sde.prior_sampling(shape, generator=generator, device=device)

        def draw():
          return torch.randn(shape, generator=generator, device=device)
      else:
        stream = iter(noise)
        x = next(stream).to(device)

        def draw():
          return next(stream).to(device)

      x_mean = x
      for t in timesteps:
        vec_t = torch.full((shape[0],), float(t), device=device)
        x, x_mean = corrector(x, vec_t, sde, score_fn, snr, n_steps, draw)
        x, x_mean = predictor(x, vec_t, sde, score_fn, probability_flow,
                              draw)
      return inverse_scaler(x_mean if denoise else x), sde.N * (n_steps + 1)

  return pc_sampler


def get_pc_sampler(sde, model, shape, predictor, corrector, inverse_scaler,
                   snr, n_steps: int = 1, probability_flow: bool = False,
                   continuous: bool = False, denoise: bool = True,
                   eps: float = 1e-3, device=None) -> Callable:
  """Predictor–corrector sampler for a score model:
  ``fn(generator=None, noise=None, params=None) -> (samples, nfe)``;
  ``params`` (``{flax name: tensor}``, e.g. a train state's EMA) replace
  the model's own for that call."""
  core = get_pc_sampler_from_score(
      sde, shape, predictor, corrector, inverse_scaler, snr,
      n_steps=n_steps, probability_flow=probability_flow,
      denoise=denoise, eps=eps, device=device)

  def pc_sampler(generator: Optional[torch.Generator] = None,
                 noise: Optional[Iterable[torch.Tensor]] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
    score_fn = mutils.get_score_fn(sde, model, train=False,
                                   continuous=continuous, params=params)
    return core(score_fn, generator=generator, noise=noise)

  return pc_sampler


# ---------------------------------------------------------------------------
# DPM-Solver++ and the probability-flow ODE sampler
# ---------------------------------------------------------------------------

def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
  """``jnp.interp(x, xp, fp)`` for increasing ``xp``: the same bracket
  (``searchsorted`` on the right, clipped), the same formula and the same
  constant ends."""
  i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
  df = fp[i] - fp[i - 1]
  dx = xp[i] - xp[i - 1]
  delta = x - xp[i - 1]
  epsilon = float(np.spacing(np.finfo(np.float32).eps))
  dx0 = dx.abs() <= epsilon
  f = torch.where(dx0, fp[i - 1],
                  fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
  f = torch.where(x < xp[0], fp[0], f)
  return torch.where(x > xp[-1], fp[-1], f)


def dpm_schedule(sde, steps: int, skip_type: str, eps: float):
  """Time grid and its (alpha, sigma, lambda) tables for DPM-Solver, as
  f32 CPU tensors: ``lambda(t) = log(alpha_t / sigma_t)``, the half-log-SNR.
  ``'logsnr'`` spaces the grid uniformly in lambda, inverting lambda(t) by
  interpolation on a 4096-point grid; ``'time'`` is the PC sampler's
  ``linspace(T, eps)``."""
  t_dense = torch.from_numpy(ode_lib.linspace(eps, sde.T, 4096))
  a_d, s_d = sde.marginal_coef(t_dense)
  lam_d = torch.log(a_d) - torch.log(s_d)           # decreasing in t
  if skip_type == 'logsnr':
    lams = torch.from_numpy(ode_lib.linspace(float(lam_d[-1]),
                                             float(lam_d[0]), steps + 1))
    ts = interp(lams, lam_d.flip(0), t_dense.flip(0))
    ts[0], ts[-1] = sde.T, eps
  elif skip_type == 'time':
    ts = torch.from_numpy(ode_lib.linspace(sde.T, eps, steps + 1))
  else:
    raise ValueError(f'Unknown dpm skip_type: {skip_type}')
  alphas, sigmas = sde.marginal_coef(ts)
  lams = torch.log(alphas) - torch.log(sigmas)
  return ts, alphas, sigmas, lams


def _check_dpm(steps: int, order: int, skip_type: Optional[str] = None):
  if order not in (1, 2):
    raise ValueError(f'dpm_order must be 1 or 2, got {order}')
  if steps < 1:
    raise ValueError(f'dpm_steps must be >= 1, got {steps}')
  if skip_type is not None and skip_type not in ('logsnr', 'time'):
    raise ValueError(f'Unknown dpm skip_type: {skip_type}')


def dpm_multistep_solve(sde, x, x0_pred_fn, steps: int = 20, order: int = 2,
                        skip_type: str = 'logsnr', eps: float = 1e-3,
                        denoise: bool = True):
  """DPM-Solver++(2M) over a data-prediction function ``x0_pred_fn(x, t)``
  (``t`` a numpy f32 scalar).

  With h_i = lam_i - lam_{i-1} and c_i = h_i / (2 h_{i-1}) (0 on the first
  step and for ``order=1``, which is DDIM): D_i = (1 + c_i) x0_i - c_i
  x0_{i-1} and x_i = (sigma_i / sigma_{i-1}) x_{i-1} - alpha_i (e^{-h_i} -
  1) D_i, x0_i the prediction at t_{i-1}.  With ``denoise`` the result is
  the prediction at the last time.  Returns ``(x, nfe)``, nfe counting
  ``x0_pred_fn`` calls.  No grad mode is set here: a caller may take
  gradients inside ``x0_pred_fn``.
  """
  _check_dpm(steps, order)
  ts, alphas, sigmas, lams = dpm_schedule(sde, steps, skip_type, eps)
  h = lams[1:] - lams[:-1]
  if order == 2 and steps > 1:
    c2 = torch.cat([torch.zeros(1), h[1:] / (2.0 * h[:-1])])
  else:
    c2 = torch.zeros(steps)
  # Per-step f32 scalars, products taken in f32 as the JAX scan does.
  ts, ratio, c2 = ts.numpy(), (sigmas[1:] / sigmas[:-1]).numpy(), c2.numpy()
  a_phi = alphas[1:].numpy() * torch.expm1(-h).numpy()
  one = np.float32(1.0)
  prev_x0 = torch.zeros_like(x)
  for i in range(steps):
    x0 = x0_pred_fn(x, ts[i])
    d = float(one + c2[i]) * x0 - float(c2[i]) * prev_x0
    x = float(ratio[i]) * x - float(a_phi[i]) * d
    prev_x0 = x0
  nfe = steps
  if denoise:
    x = x0_pred_fn(x, ts[-1])
    nfe += 1
  return x, nfe


def get_dpm_solver_sampler_from_score(sde, shape: Sequence[int],
                                      inverse_scaler, steps: int = 20,
                                      order: int = 2,
                                      skip_type: str = 'logsnr',
                                      denoise: bool = True, eps: float = 1e-3,
                                      device=None) -> Callable:
  """DPM-Solver++ (data prediction, multistep) sampler over a score
  function: ``fn(score_fn, generator=None, z=None) -> (samples, nfe)``;
  ``z`` replaces the prior draw."""
  _check_dpm(steps, order, skip_type)
  device = get_device(device)
  shape = tuple(shape)

  def sampler(score_fn, generator: Optional[torch.Generator] = None,
              z: Optional[torch.Tensor] = None):
    with torch.inference_mode():
      x = (sde.prior_sampling(shape, generator=generator, device=device)
           if z is None else z.to(device))

      def x0_pred(x, t):
        vec_t = torch.full((shape[0],), float(t), dtype=x.dtype,
                           device=device)
        a, s = sde.marginal_coef(vec_t)
        score = score_fn(x, vec_t)
        return batch_mul(1.0 / a, x + batch_mul(s ** 2, score))

      x, nfe = dpm_multistep_solve(sde, x, x0_pred, steps=steps, order=order,
                                   skip_type=skip_type, eps=eps,
                                   denoise=denoise)
      return inverse_scaler(x), nfe

  return sampler


def get_dpm_solver_sampler(sde, model, shape, inverse_scaler,
                           steps: int = 20, order: int = 2,
                           skip_type: str = 'logsnr',
                           continuous: bool = True, denoise: bool = True,
                           eps: float = 1e-3, device=None) -> Callable:
  """DPM-Solver++ sampler for a score model:
  ``fn(generator=None, z=None, params=None) -> (samples, nfe)``."""
  core = get_dpm_solver_sampler_from_score(
      sde, shape, inverse_scaler, steps=steps, order=order,
      skip_type=skip_type, denoise=denoise, eps=eps, device=device)

  def sampler(generator: Optional[torch.Generator] = None,
              z: Optional[torch.Tensor] = None,
              params: Optional[Dict[str, torch.Tensor]] = None):
    score_fn = mutils.get_score_fn(sde, model, train=False,
                                   continuous=continuous, params=params)
    return core(score_fn, generator=generator, z=z)

  return sampler


def get_ode_sampler(sde, model, shape, inverse_scaler, denoise: bool = False,
                    rtol: float = 1e-5, atol: float = 1e-5,
                    eps: float = 1e-3, n_fixed_steps: Optional[int] = None,
                    device=None) -> Callable:
  """Probability-flow ODE sampler (Dormand–Prince, or RK4 on
  ``n_fixed_steps``): ``fn(generator=None, z=None, params=None) ->
  (samples, nfe)``.  The score is the continuous one; ``denoise`` ends with
  a reverse-diffusion step's mean at ``eps``."""
  device = get_device(device)
  shape = tuple(shape)

  def ode_sampler(generator: Optional[torch.Generator] = None,
                  z: Optional[torch.Tensor] = None,
                  params: Optional[Dict[str, torch.Tensor]] = None):
    score_fn = mutils.get_score_fn(sde, model, train=False, continuous=True,
                                   params=params)
    rsde = sde.reverse(score_fn, probability_flow=True)

    def draw():
      return torch.randn(shape, generator=generator, device=device)

    def ode_func(t, x):
      vec_t = torch.full((shape[0],), float(t), dtype=x.dtype, device=device)
      return rsde.sde(x, vec_t)[0]

    with torch.inference_mode():
      x = (sde.prior_sampling(shape, generator=generator, device=device)
           if z is None else z.to(device))
      if n_fixed_steps is not None:
        x, nfe = ode_lib.odeint_rk4(ode_func, x, sde.T, eps, n_fixed_steps)
      else:
        result = ode_lib.odeint_dopri(ode_func, x, sde.T, eps, rtol=rtol,
                                      atol=atol)
        x, nfe = result.y, result.nfe
      if denoise:
        vec_eps = torch.full((shape[0],), eps, dtype=x.dtype, device=device)
        _, x = reverse_diffusion_predictor(x, vec_eps, sde, score_fn, False,
                                           draw)
      return inverse_scaler(x), nfe

  return ode_sampler
