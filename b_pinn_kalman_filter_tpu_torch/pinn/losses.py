"""PINN training losses and step functions: phase 1, the preliminary step.

Counterpart of the JAX package's ``pinn/losses.py`` ``get_pinn_optimizer``,
``_mask_and_noise``, ``_gt_flow_pyramid`` and ``get_prelim_step_fn`` (the
NS-residual step of phase 2 is ROADMAP.md A.2, the B-PINN KL terms A.3).

The flow loss reaches only the FlowNet's parameters and the pressure loss
only the PressureNet's (the PressureNet reads the ground-truth flow
pyramid, detached), so one backward of their sum gives both groups' exact
gradients; the two groups are two Adams, the PressureNet's at a smaller
learning rate, each clipped by its own global norm (optax's
``multi_transform``).

Randomness: the two masked frames' noises are normal draws from a
``torch.Generator``, f1's then f2's, unless ``noise=(n1, n2)`` gives them,
so that a test can feed in the numbers another implementation drew.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from b_pinn_kalman_filter_tpu_torch.core.losses import (MultiTransform,
                                                        get_optimizer)
from b_pinn_kalman_filter_tpu_torch.models.flownet import (
    multiscale_data_mse, pressure_data_mse, resize_bilinear)
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
from b_pinn_kalman_filter_tpu_torch.train.state import TrainState, ema_update_


def pinn_label(name: str) -> str:
  """The optimizer group of a PINN parameter: ``pres`` for the
  PressureNet's, ``flow`` for every other."""
  return 'pres' if name.split('.', 1)[0] == 'pressurenet' else 'flow'


def get_pinn_optimizer(config, lr_mul_pres: float = 1.0,
                       is_bpinn: bool = False) -> MultiTransform:
  """Two Adams: the FlowNet's at the base learning rate, the PressureNet's
  at ``lr_mul_pres`` times it; they share the warmup's count."""
  return MultiTransform(
      {'flow': get_optimizer(config, lr_mul=1.0, is_bpinn=is_bpinn),
       'pres': get_optimizer(config, lr_mul=lr_mul_pres, is_bpinn=is_bpinn)},
      pinn_label)


def mask_and_noise(f: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor,
                   variance: float) -> torch.Tensor:
  """``mask * f`` plus ``noise`` (standard normal) scaled to ``variance``."""
  return mask * f + noise * variance ** 0.5


def gt_flow_pyramid(config, target: torch.Tensor):
  """The ground-truth flow (``target[..., :2]``) and one bilinear halving
  of it per FlowNet level, coarsest first."""
  cascaded = [target[..., 0:2]]
  for _ in range(len(config.model.feature_nums)):
    prev = cascaded[-1]
    cascaded.append(resize_bilinear(prev, (prev.shape[1] // 2,
                                           prev.shape[2] // 2)))
  return cascaded[::-1]


def get_prelim_loss_fn(config, model: PINN) -> Callable:
  """``loss_fn(params, mask, batch, generator=None, noise=None) -> (loss,
  v_loss, p_loss)``: the multi-scale flow MSE of the FlowNet on the
  masked and noised frames, the pressure MSE of the PressureNet on the
  ground-truth flow pyramid, and their sum, under ``params`` (the PINN's
  flat names).  ``batch = (f1, f2, x, y, t, target)``, ``mask`` (H, W,
  1)."""
  variance = config.inverse.variance

  def loss_fn(params, mask, batch, generator=None, noise=None):
    f1, f2, x, y, t, target = batch
    if noise is None:
      noise = tuple(torch.randn(f.shape, generator=generator,
                                device=f.device) for f in (f1, f2))
    f1m = mask_and_noise(f1, mask, noise[0], variance)
    f2m = mask_and_noise(f2, mask, noise[1], variance)
    veloc_pred = model.flow_only(f1m, f2m, x, y, t, params=params)
    v_loss = multiscale_data_mse(veloc_pred, target)
    pres_pred = model.pressure_only(gt_flow_pyramid(config, target), x, y,
                                    t, params=params)
    p_loss = pressure_data_mse(pres_pred, target)
    return v_loss + p_loss, v_loss, p_loss

  return loss_fn


def get_prelim_step_fn(config, model: PINN, tx: MultiTransform,
                       train: bool) -> Callable:
  """Phase-1 step on :func:`get_prelim_loss_fn`'s loss.

  Returns ``step_fn(state, mask, batch, generator=None, noise=None) ->
  (state, (loss, v_loss, p_loss))``.  In training: the gradients of the
  loss under ``state.params``, one optimizer update of each group, the
  EMA update and the step's increment, all into ``state`` in place.  In
  evaluation: the losses under ``state.ema_params`` without gradients
  (no layer of the FlowNet or PressureNet behaves differently in
  training), ``state`` unchanged.
  """
  loss_fn = get_prelim_loss_fn(config, model)

  if train:

    def step_fn(state: TrainState, mask: torch.Tensor,
                batch: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
      loss, v_loss, p_loss = loss_fn(state.params, mask, batch, generator,
                                     noise)
      grads = torch.autograd.grad(loss, list(state.params.values()))
      tx.apply_(grads, state.opt_state, state.params)
      ema_update_(state, state.params)
      state.step += 1
      return state, (loss.detach(), v_loss.detach(), p_loss.detach())

  else:

    def step_fn(state: TrainState, mask: torch.Tensor,
                batch: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
      with torch.no_grad():
        losses = loss_fn(state.ema_params, mask, batch, generator, noise)
      return state, losses

  return step_fn
