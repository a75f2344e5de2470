"""The score-matching losses, the optimizer and the train and eval steps.

Counterpart of the JAX package's ``core/losses.py``: ``get_optimizer``
(Adam with linear warmup, global-norm clipping and coupled weight decay,
with optax's semantics), ``MultiTransform`` (optax's ``multi_transform``
over such optimizers), the continuous loss ``get_sde_loss_fn``, the
discrete losses ``get_smld_loss_fn`` (VE SDE) and ``get_ddpm_loss_fn`` (VP
SDE), and ``get_step_fn``.

Randomness comes from a ``torch.Generator``: the continuous loss draws t,
then z, then the dropout masks from it; the discrete losses draw the
integer noise levels ``labels`` in [0, N), then z, then the masks.
``noise=(t, z)`` or ``noise=(labels, z)`` replaces the first two draws, so
that a test can feed in the numbers another implementation drew.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.core.sde import batch_mul
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils
from b_pinn_kalman_filter_tpu_torch.train.state import (AdamState, Params,
                                                        TrainState,
                                                        ema_update_)


@dataclasses.dataclass(frozen=True)
class Optimizer:
  """``optax.chain(clip_by_global_norm(grad_clip),
  add_decayed_weights(weight_decay), adam(schedule, b1, b2, eps))`` with
  ``schedule(count) = lr * min(count / warmup, 1)``, applied in place.

  As in optax: the clip scales by ``grad_clip / norm`` only where the
  global norm is at least ``grad_clip`` (no epsilon), and not at all for
  ``grad_clip < 0``; the decay (``weight_decay > 0``) adds
  ``weight_decay * param`` to the gradient before the moments (torch
  Adam's coupled L2, not AdamW); the schedule reads the count *before*
  its increment (so the first update is 0 under warmup) and the bias
  corrections the count after it.
  """
  lr: float
  warmup: int
  grad_clip: float
  weight_decay: float
  b1: float
  b2: float = 0.999
  eps: float = 1e-8

  def schedule(self, count: int) -> float:
    """The learning rate at ``count``, in float32 as optax computes it."""
    if self.warmup > 0:
      return float(np.float32(self.lr) * np.minimum(
          np.float32(count) / np.float32(self.warmup), np.float32(1.0)))
    return self.lr

  def init(self, params: Params) -> AdamState:
    return AdamState(count=0,
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})

  @torch.no_grad()
  def apply_(self, grads: Sequence[torch.Tensor], opt_state: AdamState,
             params: Params) -> None:
    """One update of ``params`` (in the order of ``params``) from
    ``grads``, in place, and of ``opt_state``."""
    names = list(params)
    p = [params[k] for k in names]
    mu = [opt_state.mu[k] for k in names]
    nu = [opt_state.nu[k] for k in names]
    g = list(grads)
    if self.grad_clip >= 0:
      norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
      g = torch._foreach_mul(g, torch.where(
          norm < self.grad_clip, 1.0, self.grad_clip / norm))
    if self.weight_decay > 0:
      g = torch._foreach_add(g, p, alpha=self.weight_decay)
    torch._foreach_mul_(mu, self.b1)
    torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
    torch._foreach_mul_(nu, self.b2)
    torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1.0 - self.b2)
    count = opt_state.count + 1
    bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, self.eps)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, den)
    torch._foreach_mul_(update, -self.schedule(opt_state.count))
    torch._foreach_add_(p, update)
    opt_state.count = count


@dataclasses.dataclass(frozen=True)
class MultiTransform:
  """optax ``multi_transform``: each parameter goes to the optimizer of its
  label, ``label_fn(name)``, and each optimizer sees only its own group,
  so a clip takes the global norm of its group alone.  The state is
  ``{label: AdamState}``, keyed as optax's ``inner_states``."""
  transforms: Dict[str, Optimizer]
  label_fn: Callable[[str], str]

  def _group(self, params: Params, label: str) -> Params:
    return {k: v for k, v in params.items() if self.label_fn(k) == label}

  def init(self, params: Params) -> Dict[str, AdamState]:
    return {label: tx.init(self._group(params, label))
            for label, tx in self.transforms.items()}

  def apply_(self, grads: Sequence[torch.Tensor],
             opt_state: Dict[str, AdamState], params: Params) -> None:
    """One update of each group, in place (``grads`` in the order of
    ``params``)."""
    grads = dict(zip(params, grads))
    for label, tx in self.transforms.items():
      group = self._group(params, label)
      tx.apply_([grads[k] for k in group], opt_state[label], group)


def get_optimizer(config, lr_mul: float = 1.0,
                  is_bpinn: bool = False) -> Optimizer:
  """Adam with linear warmup and global-norm clipping from ``config.optim``:
  the learning rate ``lr * lr_mul`` and the decay ``weight_decay``, or
  with ``is_bpinn`` ``bpinn_lr * lr_mul`` and ``bpinn_weight_decay``."""
  optim = config.optim
  if optim.optimizer != 'Adam':
    raise NotImplementedError(
        f'Optimizer {optim.optimizer} not supported yet!')
  lr, decay = ((optim.bpinn_lr, optim.bpinn_weight_decay) if is_bpinn
               else (optim.lr, optim.weight_decay))
  return Optimizer(lr=lr * lr_mul, warmup=optim.warmup,
                   grad_clip=optim.grad_clip, weight_decay=decay,
                   b1=optim.beta1, eps=optim.eps)


def _reduce_op(reduce_mean: bool):
  if reduce_mean:
    return lambda x: torch.mean(x, dim=-1)
  return lambda x: 0.5 * torch.sum(x, dim=-1)


def get_sde_loss_fn(sde, model, train: bool, reduce_mean: bool = True,
                    continuous: bool = True,
                    likelihood_weighting: bool = True,
                    eps: float = 1e-5) -> Callable:
  """Continuous denoising score matching:
  ``loss_fn(params, batch, generator=None, noise=None)``, the mean loss
  over the batch under ``params``.  t ~ U(eps, T) and z ~ N(0, 1) come
  from ``generator`` unless ``noise=(t, z)`` gives them; in training the
  dropout masks come from ``generator`` after them."""
  reduce_op = _reduce_op(reduce_mean)

  def loss_fn(params: Params, batch: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    score_fn = mutils.get_score_fn(sde, model, train=train,
                                   continuous=continuous, params=params)
    if noise is None:
      t = torch.rand((batch.shape[0],), generator=generator,
                     device=batch.device) * (sde.T - eps) + eps
      z = torch.randn(batch.shape, generator=generator, device=batch.device)
    else:
      t, z = noise
    mean, std = sde.marginal_prob(batch, t)
    perturbed_data = mean + batch_mul(std, z)
    score = score_fn(perturbed_data, t, generator)

    if not likelihood_weighting:
      losses = torch.square(batch_mul(std, score) + z)
      losses = reduce_op(losses.reshape(losses.shape[0], -1))
    else:
      g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
      losses = torch.square(score + batch_mul(1.0 / std, z))
      losses = reduce_op(losses.reshape(losses.shape[0], -1)) * g2
    return torch.mean(losses)

  return loss_fn


def _labels_and_noise(N: int, batch: torch.Tensor, generator, noise):
  """(labels, z): ``noise`` where given, else labels uniform in [0, N)
  then z ~ N(0, 1) of the batch's shape from ``generator``."""
  if noise is not None:
    labels, z = noise
    return labels.to(batch.device), z.to(batch.device)
  labels = torch.randint(0, N, (batch.shape[0],), generator=generator,
                         device=batch.device)
  return labels, torch.randn(batch.shape, generator=generator,
                             device=batch.device)


def get_smld_loss_fn(vesde, model, train: bool,
                     reduce_mean: bool = False) -> Callable:
  """The SMLD (NCSN) loss: ``loss_fn(params, batch, generator=None,
  noise=None)``.  At the noise level ``labels`` (the model's input), sigma
  is ``flip(discrete_sigmas)[labels]`` (the models take the sigmas in
  descending order); the loss is the squared error of the score of
  ``batch + sigma z`` against ``-z / sigma``, reduced over each image and
  weighted by sigma**2, then its batch mean."""
  if not isinstance(vesde, sde_lib.VESDE):
    raise ValueError('SMLD training only works for VESDEs.')
  sigmas_desc = torch.flip(vesde.discrete_sigmas, dims=(0,))
  reduce_op = _reduce_op(reduce_mean)

  def loss_fn(params: Params, batch: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    model_fn = mutils.get_model_fn(model, train=train, params=params)
    labels, z = _labels_and_noise(vesde.N, batch, generator, noise)
    sigmas = sigmas_desc.to(batch.device)[labels]
    scaled = batch_mul(sigmas, z)
    score = model_fn(scaled + batch, labels, generator)
    target = -batch_mul(1.0 / sigmas ** 2, scaled)
    losses = torch.square(score - target)
    losses = reduce_op(losses.reshape(losses.shape[0], -1)) * sigmas ** 2
    return torch.mean(losses)

  return loss_fn


def get_ddpm_loss_fn(vpsde, model, train: bool,
                     reduce_mean: bool = True) -> Callable:
  """The discrete DDPM loss: ``loss_fn(params, batch, generator=None,
  noise=None)``, the squared error of the model's output at
  ``sqrt(alphas_cumprod[labels]) batch + sqrt(1 - alphas_cumprod[labels])
  z`` (``labels`` its input) against z, reduced over each image, then its
  batch mean."""
  if not isinstance(vpsde, sde_lib.VPSDE):
    raise ValueError('DDPM training only works for VPSDEs.')
  reduce_op = _reduce_op(reduce_mean)

  def loss_fn(params: Params, batch: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    model_fn = mutils.get_model_fn(model, train=train, params=params)
    labels, z = _labels_and_noise(vpsde.N, batch, generator, noise)
    perturbed_data = (
        batch_mul(vpsde.sqrt_alphas_cumprod.to(batch.device)[labels], batch)
        + batch_mul(vpsde.sqrt_1m_alphas_cumprod.to(batch.device)[labels], z))
    score = model_fn(perturbed_data, labels, generator)
    losses = torch.square(score - z)
    losses = reduce_op(losses.reshape(losses.shape[0], -1))
    return torch.mean(losses)

  return loss_fn


def get_step_fn(sde, model, tx: Optimizer, train: bool,
                reduce_mean: bool = False, continuous: bool = True,
                likelihood_weighting: bool = False) -> Callable:
  """``step_fn(state, batch, generator=None, noise=None) -> (state,
  loss)`` on the continuous loss, or with ``continuous`` False on the
  SMLD loss for a VE SDE and the DDPM loss for a VP SDE (``ValueError``
  for another SDE, and for ``likelihood_weighting``, which they lack).

  In training: the loss and its gradients under ``state.params``, one
  optimizer update, the EMA update and the step's increment, all into
  ``state`` in place.  In evaluation: the loss under ``state.ema_params``
  without gradients, ``state`` unchanged.
  """
  if continuous:
    loss_fn = get_sde_loss_fn(sde, model, train, reduce_mean=reduce_mean,
                              continuous=True,
                              likelihood_weighting=likelihood_weighting)
  elif likelihood_weighting:
    raise ValueError('Likelihood weighting is not supported for original '
                     'SMLD/DDPM training.')
  elif isinstance(sde, sde_lib.VESDE):
    loss_fn = get_smld_loss_fn(sde, model, train, reduce_mean=reduce_mean)
  elif isinstance(sde, sde_lib.VPSDE):
    loss_fn = get_ddpm_loss_fn(sde, model, train, reduce_mean=reduce_mean)
  else:
    raise ValueError(f'Discrete training for {sde.__class__.__name__} is '
                     'not recommended.')

  if train:

    def step_fn(state: TrainState, batch, generator=None, noise=None):
      loss = loss_fn(state.params, batch, generator, noise)
      # A parameter outside the graph (NCSN++'s Fourier projection ``W``,
      # under ``stop_gradient`` in JAX) gets a zero gradient, as in JAX.
      grads = torch.autograd.grad(loss, list(state.params.values()),
                                  allow_unused=True, materialize_grads=True)
      tx.apply_(grads, state.opt_state, state.params)
      ema_update_(state, state.params)
      state.step += 1
      return state, loss.detach()

  else:

    def step_fn(state: TrainState, batch, generator=None, noise=None):
      with torch.no_grad():
        loss = loss_fn(state.ema_params, batch, generator, noise)
      return state, loss

  return step_fn
