"""Bayesian PINN: mean-field Gaussian posteriors over every weight, their
KL terms, and the B-PINN train step.

Counterpart of the JAX package's ``pinn/bayes.py`` (posterior set-up,
draws, Monte-Carlo prediction, ``kl_loss`` and
``get_bpinn_prelim_step_fn``).

A posterior is ``{'flownet': {'mu': {...}, 'rho': {...}}, 'pressurenet':
...}``, where ``mu`` and ``rho`` map each parameter name of that PINN
sub-module to a tensor.  A train state holds it flat
(:func:`flatten_posterior`): ``{'flownet.mu.<name>': tensor,
'flownet.rho.<name>': ..., 'pressurenet.mu.<name>': ..., ...}``, so that
the PINN optimizer's label (``pinn/losses.py`` ``pinn_label``) puts mu and
rho of a sub-network in that sub-network's group, as optax's
``multi_transform`` does with the JAX posterior tree.  A draw ``w = mu +
softplus(rho) * eps`` is a flat ``{'flownet.<name>': tensor, ...}`` dict of
the whole PINN, which ``torch.func.functional_call`` runs;
:func:`sample_uvp` stacks the draws and runs them as one vmapped forward.
Draws come from an explicit ``torch.Generator``, or are handed in
(``draws=``, ``eps=``), as the tests hand in the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from b_pinn_kalman_filter_tpu_torch.models.flownet import (multiscale_data_mse,
                                                           pressure_data_mse)
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.train.state import ema_update_

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


def flatten_posterior(bparams: dict) -> Dict[str, Tensor]:
  """The posterior as a train state holds it: ``{'<key>.mu.<name>': ...,
  '<key>.rho.<name>': ...}``, key by key, mu before rho (the same
  tensors)."""
  return {f'{key}.{part}.{name}': value for key in bparams
          for part in ('mu', 'rho')
          for name, value in bparams[key][part].items()}


def nest_posterior(flat: Dict[str, Tensor]) -> dict:
  """:func:`flatten_posterior` undone (the same tensors)."""
  out: dict = {}
  for name, value in flat.items():
    key, part, rest = name.split('.', 2)
    out.setdefault(key, {'mu': {}, 'rho': {}})[part][rest] = value
  return out


def by_key(params: Dict[str, Tensor]) -> Dict[str, Dict[str, Tensor]]:
  """A PINN's flat parameters ``{'flownet.<name>': ...}`` as ``{'flownet':
  {name: ...}, 'pressurenet': {...}}`` (the same tensors)."""
  out: Dict[str, Dict[str, Tensor]] = {}
  for name, value in params.items():
    key, rest = name.split('.', 1)
    out.setdefault(key, {})[rest] = value
  return out


def sample_eps(generator: torch.Generator, bparams: dict) -> Draw:
  """Standard normal ``eps`` for each parameter of the PINN, under its flat
  name, drawn key by key in the posterior's order.  The generator must
  live on the parameters' device."""
  return {f'{key}.{name}': torch.randn(m.shape, generator=generator,
                                       dtype=m.dtype, device=m.device)
          for key in bparams for name, m in bparams[key]['mu'].items()}


def draw_params(bparams: dict, eps: Draw) -> Draw:
  """The reparameterised draw ``mu + softplus(rho) * eps`` of the whole
  PINN's parameters (differentiable in mu and rho)."""
  return {f'{key}.{name}': m + F.softplus(bparams[key]['rho'][name])
          * eps[f'{key}.{name}']
          for key in bparams for name, m in bparams[key]['mu'].items()}


def sample_params(generator: torch.Generator, bparams: dict) -> Draw:
  """One reparameterised draw of the whole PINN's parameters."""
  return draw_params(bparams, sample_eps(generator, bparams))


def gaussian_kl(mu: Tensor, sigma: Tensor, prior_mu: float,
                prior_sigma: float) -> Tensor:
  """KL(N(mu, sigma^2) || N(prior_mu, prior_sigma^2)), summed."""
  return torch.sum(torch.log(prior_sigma / sigma)
                   + (sigma ** 2 + (mu - prior_mu) ** 2)
                   / (2 * prior_sigma ** 2) - 0.5)


def kl_loss(bparams: dict) -> Tuple[Tensor, Tensor]:
  """(kl_flownet, kl_pressurenet), each sub-network's posterior against its
  own prior (``FLOW_PRIOR``, ``PRES_PRIOR``)."""
  kls = {}
  for key, prior in KEYS:
    mu, rho = bparams[key]['mu'], bparams[key]['rho']
    kls[key] = torch.stack([
        gaussian_kl(m, F.softplus(rho[name]), prior['prior_mu'],
                    prior['prior_sigma']) for name, m in mu.items()]).sum()
  return kls['flownet'], kls['pressurenet']


def _draws(n: int, bparams: dict, generator: Optional[torch.Generator],
           draws: Optional[Sequence[Draw]]) -> Sequence[Draw]:
  if draws is not None:
    if len(draws) != n:
      raise ValueError(f'{len(draws)} draws handed in, {n} asked for')
    return draws
  if generator is None:
    raise ValueError('pass a generator or the draws')
  return [sample_params(generator, bparams) for _ in range(n)]


def stack_draws(draws: Sequence[Draw]) -> Draw:
  """Draws stacked along a new leading dimension, name by name."""
  return {name: torch.stack([d[name] for d in draws]) for name in draws[0]}


def sample_uvp(model, bparams: dict, f1, f2, x, y, t, n: int = 64,
               size=None, generator: Optional[torch.Generator] = None,
               draws: Optional[Sequence[Draw]] = None) -> Tuple[Tensor, Tensor]:
  """``n`` posterior draws of the PINN forward, as one batched forward.

  Returns (flows (n, B, H, W, 2), pressures (n, B, H, W, 1)).  The draws
  (from ``generator``, in order, or handed in) are stacked and the PINN
  runs once under ``torch.func.vmap`` over them, as the JAX package's
  ``jax.vmap`` over the draws does: each convolution becomes one grouped
  convolution over the draws, and each pyramid level's cost volume one
  call at batch n * B (one launch of kernel K3 on the card).
  """
  params = stack_draws(_draws(n, bparams, generator, draws))

  def one(p):
    flow, pres = functional_call(model, p, (f1, f2, x, y, t),
                                 {'size': size}, strict=True)
    return flow[-1], pres

  return torch.func.vmap(one)(params)


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


def get_bpinn_loss_fn(config, model) -> Callable:
  """``loss_fn(params, mask, batch, generator=None, noise=None, eps=None)
  -> (loss, v_loss, p_loss, terms)``: the B-PINN loss under the flat
  posterior ``params`` (:func:`flatten_posterior`'s names).

  The frames are masked and noised as in the prelim loss (the noises from
  ``generator``, f1's then f2's, unless ``noise`` gives them); then one
  posterior draw (its ``eps`` from ``generator`` after the noises, unless
  ``eps`` gives them, by the PINN's flat names).  The FlowNet's
  multi-scale flow MSE on the masked frames and the PressureNet's
  pressure MSE on the ground-truth flow pyramid, both under the draw, take
  the KL terms of their sub-networks: ``v_loss = flow_mse + kl_flow / bs *
  0.1``, ``p_loss = pres_mse + kl_pres / bs * 0.01``, with ``bs`` the
  config's ``training.batch_size``.  ``terms`` holds the four parts apart
  (``flow_mse``, ``pres_mse``, ``kl_flow``, ``kl_pres``): the KL parts of
  the sums are thousands of times the MSEs, so the sums' rounding would
  hide an error in the MSEs.
  """
  bs = config.training.batch_size

  def loss_fn(params, mask, batch, generator=None, noise=None, eps=None):
    _, _, x, y, t, target = batch
    f1m, f2m = pinn_losses.masked_frames(config, batch, mask, generator,
                                         noise)
    bparams = nest_posterior(params)
    if eps is None:
      eps = sample_eps(generator, bparams)
    draw = draw_params(bparams, eps)
    veloc_pred = model.flow_only(f1m, f2m, x, y, t, params=draw)
    flow_mse = multiscale_data_mse(veloc_pred, target)
    pres_pred = model.pressure_only(
        pinn_losses.gt_flow_pyramid(config, target), x, y, t, params=draw)
    pres_mse = pressure_data_mse(pres_pred, target)
    kl_flow, kl_pres = kl_loss(bparams)
    v_loss = flow_mse + kl_flow / bs * 0.1
    p_loss = pres_mse + kl_pres / bs * 0.01
    terms = dict(flow_mse=flow_mse, pres_mse=pres_mse, kl_flow=kl_flow,
                 kl_pres=kl_pres)
    return v_loss + p_loss, v_loss, p_loss, terms

  return loss_fn


def get_bpinn_prelim_step_fn(config, model, tx, train: bool) -> Callable:
  """The B-PINN step on :func:`get_bpinn_loss_fn`'s loss.

  Returns ``step_fn(state, mask, batch, generator=None, noise=None,
  eps=None) -> (state, (loss, v_loss, p_loss))``, ``state.params`` the
  flat posterior.  In training: the gradients of the loss in mu and rho
  (through the draw and the KL terms), one update of each optimizer group
  (``tx``, ``pinn/losses.py`` ``get_pinn_optimizer``), the EMA update of
  mu and rho and the step's increment, all into ``state`` in place; no
  NaN gate, as in the JAX step.  In evaluation: the losses under
  ``state.ema_params`` with a fresh draw, without gradients, ``state``
  unchanged.
  """
  loss_fn = get_bpinn_loss_fn(config, model)

  if train:

    def step_fn(state, mask, batch, generator=None, noise=None, eps=None):
      loss, v_loss, p_loss, _ = loss_fn(state.params, mask, batch,
                                        generator, noise, eps)
      grads = torch.autograd.grad(loss, list(state.params.values()))
      tx.apply_(grads, state.opt_state, state.params)
      ema_update_(state, state.params)
      state.step += 1
      return state, (loss.detach(), v_loss.detach(), p_loss.detach())

  else:

    def step_fn(state, mask, batch, generator=None, noise=None, eps=None):
      with torch.no_grad():
        loss, v_loss, p_loss, _ = loss_fn(state.ema_params, mask, batch,
                                          generator, noise, eps)
      return state, (loss, v_loss, p_loss)

  return step_fn
