"""Predictor–corrector sampler in PyTorch.

Counterpart of the JAX package's ``core/sampling.py``, for the PC sampler
of the flagship config: the ``euler_maruyama`` predictor, the ``none``
predictor and corrector, ``get_pc_sampler_from_score``,
``get_pc_sampler`` and the ``pc`` branch of ``get_sampling_fn``.  The other
samplers raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them.

Where JAX scans the N steps as one program, this is a loop on the host
that launches each step's kernels in turn.  Randomness comes from a
``torch.Generator``, or from an explicit noise source so that a test can
feed in the numbers another implementation drew.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.core.sde import batch_mul
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils

_PREDICTORS = {}
_CORRECTORS = {}
# Registered in JAX but not ported yet: ROADMAP.md A.5.
_LATER = ('reverse_diffusion', 'ancestral_sampling', 'langevin', 'ald')


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


def _lookup(registry, kind: str, name: str):
  if name in registry:
    return registry[name]
  if name in _LATER:
    raise NotImplementedError(
        f'{kind} {name!r} is not ported yet: ROADMAP.md A.5 (PC sampler)')
  raise KeyError(f'unknown {kind} {name!r}')


def get_predictor(name: str):
  return _lookup(_PREDICTORS, 'predictor', name)


def get_corrector(name: str):
  return _lookup(_CORRECTORS, 'corrector', name)


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


@register_predictor(name='none')
def none_predictor(x, t, sde, score_fn, probability_flow, draw):
  return x, x


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
    raise NotImplementedError(
        'the ODE sampler is not ported yet: ROADMAP.md A.7')
  elif sampler_name == 'dpm_solver':
    raise NotImplementedError(
        'the DPM-Solver sampler is not ported yet: ROADMAP.md A.6')
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
