"""PINN training losses and step functions: phase 1, the preliminary step,
and phase 2, the step with the Navier–Stokes residual.

Counterpart of the JAX package's ``pinn/losses.py`` ``get_pinn_optimizer``,
``_mask_and_noise``, ``_gt_flow_pyramid``, ``get_prelim_step_fn`` and
``get_pinn_step_fn`` (the B-PINN step is ``pinn/bayes.py``'s; the
microbatched residual gradient of ``tpu.pinn_microbatch`` is ROADMAP.md
A.14).

The flow loss reaches only the FlowNet's parameters and the pressure loss
only the PressureNet's (the PressureNet reads the ground-truth flow
pyramid, detached), so one backward of their sum gives both groups' exact
gradients; the two groups are two Adams, the PressureNet's at a smaller
learning rate, each clipped by its own global norm (optax's
``multi_transform``).

Phase 2's data loss is that of the whole PINN, the PressureNet on the
predicted flow; its residual term (``pinn.equation_mse``, Re fixed at 1e7)
differentiates the PINN three times, and a step whose gradient has a
non-finite element changes nothing in the state.

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
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import (PINN,
                                                     equation_mse_from_outputs)
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


def masked_frames(config, batch, mask, generator, noise):
  """The batch's two frames masked and noised (the noises from
  ``generator``, f1's then f2's, unless ``noise`` gives them)."""
  f1, f2 = batch[:2]
  if noise is None:
    noise = tuple(torch.randn(f.shape, generator=generator, device=f.device)
                  for f in (f1, f2))
  return tuple(mask_and_noise(f, mask, n, config.inverse.variance)
               for f, n in zip((f1, f2), noise))


def get_prelim_loss_fn(config, model: PINN) -> Callable:
  """``loss_fn(params, mask, batch, generator=None, noise=None) -> (loss,
  v_loss, p_loss)``: the multi-scale flow MSE of the FlowNet on the
  masked and noised frames, the pressure MSE of the PressureNet on the
  ground-truth flow pyramid, and their sum, under ``params`` (the PINN's
  flat names).  ``batch = (f1, f2, x, y, t, target)``, ``mask`` (H, W,
  1)."""

  def loss_fn(params, mask, batch, generator=None, noise=None):
    _, _, x, y, t, target = batch
    f1m, f2m = masked_frames(config, batch, mask, generator, noise)
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


RE = 1e7   # the JAX get_pinn_step_fn's fixed Reynolds number


def get_pinn_loss_fn(config, model: PINN) -> Callable:
  """``loss_fn(params, mask, batch, generator=None, noise=None,
  create_graph=True) -> (loss, pinn_loss, data_loss)``: the data loss
  (the multi-scale flow MSE and the pressure MSE of one PINN forward on
  the masked and noised frames, the PressureNet on the predicted flow),
  ``training.pinn_loss_weight`` times the NS residual of the same PINN at
  Re = 1e7, and their sum, under ``params``.  ``create_graph`` False
  keeps no graph of the parameters (an evaluation)."""
  weight = config.training.pinn_loss_weight

  def loss_fn(params, mask, batch, generator=None, noise=None,
              create_graph=True):
    _, _, x, y, t, target = batch
    f1m, f2m = masked_frames(config, batch, mask, generator, noise)
    with torch.set_grad_enabled(create_graph):
      flow_pred, pres_pred = torch.func.functional_call(
          model, params, (f1m, f2m, x, y, t), strict=True)
      data_loss = (multiscale_data_mse(flow_pred, target)
                   + pressure_data_mse(pres_pred, target))
    pinn_loss = equation_mse_from_outputs(
        model, params, f1m, f2m, x, y, t, RE,
        create_graph=create_graph) * weight
    return pinn_loss + data_loss, pinn_loss, data_loss

  return loss_fn


def all_finite(tensors: Sequence[torch.Tensor]) -> bool:
  """Whether every element of every tensor is finite, in one host read
  (0 * x is NaN exactly where x is not finite)."""
  zeros = torch._foreach_mul(list(tensors), 0.0)
  return bool(torch.stack(torch._foreach_norm(zeros)).sum() == 0)


def get_pinn_step_fn(config, model: PINN, tx: MultiTransform,
                     train: bool) -> Callable:
  """Phase-2 step on :func:`get_pinn_loss_fn`'s loss.

  Returns ``step_fn(state, mask, batch, generator=None, noise=None) ->
  (state, (loss, pinn_loss, data_loss))``.  In training: the gradients of
  the loss under ``state.params``; where every element of them is finite,
  one optimizer update of each group, the EMA update and the step's
  increment, all into ``state`` in place; otherwise (the JAX step's
  NaN gate) nothing in ``state`` changes.  In evaluation: the losses under
  ``state.ema_params``, with the coordinate derivatives the residual
  needs but no graph of the parameters, ``state`` unchanged.
  """
  loss_fn = get_pinn_loss_fn(config, model)

  if train:

    def step_fn(state: TrainState, mask: torch.Tensor,
                batch: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
      loss, pinn_loss, data_loss = loss_fn(state.params, mask, batch,
                                           generator, noise)
      grads = torch.autograd.grad(loss, list(state.params.values()))
      if all_finite(grads):
        tx.apply_(grads, state.opt_state, state.params)
        ema_update_(state, state.params)
        state.step += 1
      return state, (loss.detach(), pinn_loss.detach(), data_loss.detach())

  else:

    def step_fn(state: TrainState, mask: torch.Tensor,
                batch: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
      losses = loss_fn(state.ema_params, mask, batch, generator, noise,
                       create_graph=False)
      return state, tuple(v.detach() for v in losses)

  return step_fn
