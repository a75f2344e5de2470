"""Bayesian PINN: mean-field Gaussian posteriors over every weight.

Counterpart of the JAX package's ``pinn/bayes.py`` (posterior set-up,
draws and Monte-Carlo prediction; the KL terms come with training).

A posterior is ``{'flownet': {'mu': {...}, 'rho': {...}}, 'pressurenet':
...}``, where ``mu`` and ``rho`` map each parameter name of that PINN
sub-module to a tensor.  A draw ``w = mu + softplus(rho) * eps`` is a flat
``{'flownet.<name>': tensor, ...}`` dict of the whole PINN, which
``torch.func.functional_call`` runs.  Draws come from an explicit
``torch.Generator``, or are handed in (``draws=``), as the tests hand in
the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

Tensor = torch.Tensor
Draw = Dict[str, Tensor]

FLOW_PRIOR = dict(prior_mu=0.0, prior_sigma=0.1, posterior_mu_init=0.0,
                  posterior_rho_init=-3.0)
PRES_PRIOR = dict(prior_mu=0.0, prior_sigma=0.01, posterior_mu_init=0.0,
                  posterior_rho_init=-0.5)
KEYS = (('flownet', FLOW_PRIOR), ('pressurenet', PRES_PRIOR))


def inv_softplus(y: Tensor) -> Tensor:
  """softplus^-1(y) = log(expm1(y)), y floored at 1e-12."""
  return torch.log(torch.expm1(torch.clamp(y, min=1e-12)))


def init_bayesian(params: Dict[str, Tensor], rho_init: float) -> dict:
  """Posterior around ``params`` with a constant rho."""
  return {'mu': {k: v.detach().clone() for k, v in params.items()},
          'rho': {k: torch.full_like(v, rho_init) for k, v in params.items()}}


def init_bayesian_moped(params: Dict[str, Tensor], delta: float) -> dict:
  """MOPED posterior from pretrained params: sigma = delta * |w|."""
  return {'mu': {k: v.detach().clone() for k, v in params.items()},
          'rho': {k: inv_softplus(delta * v.detach().abs())
                  for k, v in params.items()}}


def make_bpinn_params(pinn_params: Dict[str, Dict[str, Tensor]], config,
                      pretrained: bool = True) -> dict:
  """The B-PINN posterior from PINN parameters ``{'flownet': {...},
  'pressurenet': {...}}``: MOPED when ``pretrained``, else the priors'
  constant rho."""
  delta = config.model.bpinn_moped_delta
  out = {}
  for key, prior in KEYS:
    if pretrained:
      out[key] = init_bayesian_moped(pinn_params[key], delta)
    else:
      out[key] = init_bayesian(pinn_params[key], prior['posterior_rho_init'])
  return out


def sample_params(generator: torch.Generator, bparams: dict) -> Draw:
  """One reparameterised draw of the whole PINN's parameters.  The
  generator must live on the parameters' device."""
  out = {}
  for key in bparams:
    mu, rho = bparams[key]['mu'], bparams[key]['rho']
    for name, m in mu.items():
      eps = torch.randn(m.shape, generator=generator, dtype=m.dtype,
                        device=m.device)
      out[f'{key}.{name}'] = m + F.softplus(rho[name]) * eps
  return out


def _draws(n: int, bparams: dict, generator: Optional[torch.Generator],
           draws: Optional[Sequence[Draw]]) -> Sequence[Draw]:
  if draws is not None:
    if len(draws) != n:
      raise ValueError(f'{len(draws)} draws handed in, {n} asked for')
    return draws
  if generator is None:
    raise ValueError('pass a generator or the draws')
  return [sample_params(generator, bparams) for _ in range(n)]


def sample_uvp(model, bparams: dict, f1, f2, x, y, t, n: int = 64,
               size=None, generator: Optional[torch.Generator] = None,
               draws: Optional[Sequence[Draw]] = None) -> Tuple[Tensor, Tensor]:
  """``n`` posterior draws of the PINN forward, one after another.

  Returns (flows (n, B, H, W, 2), pressures (n, B, H, W, 1)).  Each draw
  is one FlowNet forward, so ``n`` draws call the cost volume (kernel K3)
  ``n`` times per pyramid level.
  """
  flows: List[Tensor] = []
  press: List[Tensor] = []
  for params in _draws(n, bparams, generator, draws):
    flow, pres = functional_call(model, params, (f1, f2, x, y, t),
                                 {'size': size}, strict=True)
    flows.append(flow[-1])
    press.append(pres)
  return torch.stack(flows), torch.stack(press)


def predict(model, bparams: dict, f1, f2, x, y, t, dt: float, n: int = 64,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Sequence[Draw]] = None):
  """MC mean and std (population) of flow, pressure and the advected
  field."""
  from b_pinn_kalman_filter_tpu_torch.pinn.pinn import pinn_step

  flows, press = sample_uvp(model, bparams, f1, f2, x, y, t, n=n,
                            generator=generator, draws=draws)
  f_pred = torch.stack([pinn_step(f2, u, dt) for u in flows])
  return (flows.mean(0), press.mean(0), f_pred.mean(0),
          flows.std(0, correction=0), press.std(0, correction=0),
          f_pred.std(0, correction=0))
