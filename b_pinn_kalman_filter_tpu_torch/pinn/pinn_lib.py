"""PINN set-up and training: ``init_pinn`` and the two phases of
``train``: phase 1, the preliminary FlowNet + PressureNet training on
masked and noised frames (also on its own, :func:`train_prelim`), and
phase 2, the training with the Navier–Stokes residual.

Counterpart of the JAX package's ``pinn/pinn_lib.py`` ``init_pinn``,
``unbatch``, ``_run_phase`` and ``train``.  ``train_bpinn`` is ROADMAP.md
A.3.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.data.datasets import (get_dataset,
                                                          get_mask_dataset)
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib

logger = logging.getLogger(__name__)


def init_pinn(config, seed: Optional[int] = None, device=None
              ) -> Tuple[PINN, Dict[str, Dict[str, torch.Tensor]]]:
  """The PINN on ``device`` (default ``cuda``) in eval mode, its
  parameters drawn by the flax inits from a CPU generator seeded with
  ``seed`` (default ``config.seed``).  Returns ``(model, params)`` with
  params ``{'flownet': {name: tensor}, 'pressurenet': {...}}``, the shape
  of the JAX ``variables['params']``."""
  device = get_device(device)
  model = PINN(config)
  seed = config.seed if seed is None else seed
  layers.init_params(model, torch.Generator().manual_seed(seed))
  model = model.to(device).eval()
  params = {key: {name: p.detach()
                  for name, p in getattr(model, key).named_parameters()}
            for key in ('flownet', 'pressurenet')}
  return model, params


def unbatch(batch: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, ...]:
  """``(f1, f2, x, y, t, target)`` host arrays as float32 tensors on
  ``device``."""
  return tuple(torch.from_numpy(np.asarray(b, np.float32)).to(device)
               for b in batch)


def _run_phase(config, state, step_fns, mask_it, train_iter, eval_iter,
               start_step: int, end_step: int, ckpt_dirs: Tuple[str, str],
               tag: str, generator: torch.Generator, device,
               history: Optional[List[Dict[str, Any]]] = None):
  """Steps ``start_step`` .. ``end_step`` of one phase, each on a fresh
  batch and mask.  After the update of step ``s``: the losses logged (``s
  % log_freq == 0``), the eval losses under the EMA on an eval batch with
  the same mask (``s % eval_freq == 0``), the preemption checkpoint (``s
  != 0`` and ``s % snapshot_freq_for_preemption == 0``) and a snapshot
  ``checkpoint_{s // snapshot_freq}`` (``s != 0`` and ``s % snapshot_freq
  == 0``, or ``s == end_step``)."""
  train_step_fn, eval_step_fn = step_fns
  checkpoint_dir, checkpoint_meta = ckpt_dirs
  t = config.training
  events = {
      'log': lambda s: s % t.log_freq == 0,
      'eval': lambda s: s % t.eval_freq == 0,
      'preempt_ckpt':
          lambda s: s != 0 and s % t.snapshot_freq_for_preemption == 0,
      'snapshot':
          lambda s: (s != 0 and s % t.snapshot_freq == 0) or s == end_step,
  }
  for step in range(start_step, end_step + 1):
    start = time.perf_counter()
    batch = unbatch(next(train_iter), device)
    mask = torch.from_numpy(mask_it.next()).to(device)
    state, (loss, l_a, l_b) = train_step_fn(state, mask, batch, generator)
    fired = [name for name, due in events.items() if due(step)]

    if 'log' in fired:
      logger.info('step: %d, %s_loss: %.5e = (%.5e, %.5e)', step, tag,
                  float(loss), float(l_a), float(l_b))
    if 'eval' in fired:
      eval_batch = unbatch(next(eval_iter), device)
      _, (e_loss, e_a, e_b) = eval_step_fn(state, mask, eval_batch,
                                           generator)
      logger.info('step: %d, eval_%s_loss: %.5e = (%.5e, %.5e)', step, tag,
                  float(e_loss), float(e_a), float(e_b))
    if 'preempt_ckpt' in fired:
      ckpt_lib.save_checkpoint(checkpoint_meta, state)
    if 'snapshot' in fired:
      save_step = step // t.snapshot_freq
      ckpt_lib.save_checkpoint(
          os.path.join(checkpoint_dir, f'checkpoint_{save_step}'), state)
      logger.info('checkpoint_%d saved', save_step)

    if history is not None:
      if device.type == 'cuda':
        torch.cuda.synchronize(device)
      history.append(dict(phase=tag, step=step,
                          seconds=time.perf_counter() - start,
                          loss=float(loss), events=fired))
  return state


class _Run:
  """What the phases of one training run share: the model, the mask and
  data iterators, the noise generator and the checkpoint paths, all
  carried from phase 1 on into phase 2."""

  def __init__(self, config, workdir: str, device):
    self.config = config
    self.device = device
    self.checkpoint_dir = os.path.join(workdir, 'checkpoints')
    meta = os.path.join(workdir, 'checkpoints-meta')
    self.checkpoint_meta = os.path.join(meta, 'checkpoint')
    self.checkpoint_pinn = os.path.join(meta, 'checkpoint_pinn')
    for d in (self.checkpoint_dir, meta):
      os.makedirs(d, exist_ok=True)
    self.model, _ = init_pinn(config, device=device)
    self.mask_it = get_mask_dataset(config)
    train_ds, eval_ds = get_dataset(config, device=device)
    self.train_iter: Iterator = iter(train_ds)
    self.eval_iter: Iterator = iter(eval_ds)
    self.generator = torch.Generator(device=device).manual_seed(config.seed)

  def phase(self, state, get_step_fn, tx, end_step: int, meta: str,
            tag: str, history):
    step_fns = (get_step_fn(self.config, self.model, tx, train=True),
                get_step_fn(self.config, self.model, tx, train=False))
    return _run_phase(self.config, state, step_fns, self.mask_it,
                      self.train_iter, self.eval_iter, state.step, end_step,
                      (self.checkpoint_dir, meta), tag, self.generator,
                      self.device, history)

  def prelim(self, history) -> state_lib.TrainState:
    """Phase 1: ``get_pinn_optimizer`` with the PressureNet's learning
    rate x 0.001 from the seeded init, the preemption checkpoint
    ``checkpoints-meta/checkpoint`` restored when present, steps up to
    ``training.n_iters``."""
    tx = pinn_losses.get_pinn_optimizer(self.config, lr_mul_pres=0.001)
    state = state_lib.create_train_state(
        dict(self.model.named_parameters()), tx, self.config.model.ema_rate)
    state = ckpt_lib.restore_checkpoint(self.checkpoint_meta, state,
                                        quiet=True)
    logger.info('Starting Preliminary Training loop at step %d.', state.step)
    return self.phase(state, pinn_losses.get_prelim_step_fn, tx,
                      self.config.training.n_iters, self.checkpoint_meta,
                      'prelim', history)


def train_prelim(config, workdir: str, *, device=None,
                 history: Optional[List[Dict[str, Any]]] = None
                 ) -> state_lib.TrainState:
  """Phase 1 of PINN training on ``device`` (default ``cuda``): steps 0 ..
  ``training.n_iters``; returns the final train state.

  The JAX ``train``'s first phase, step for step: the PINN's seeded init;
  ``get_pinn_optimizer`` with the PressureNet's learning rate x 0.001;
  the preemption checkpoint ``workdir/checkpoints-meta/checkpoint``
  restored at start when present; then ``_run_phase``'s steps and events,
  snapshots under ``workdir/checkpoints``.  Losses go to this module's
  logger (no TensorBoard writer).  The masks come from
  ``get_mask_dataset``, the batches from ``get_dataset`` (on the PDE
  config, the synthetic rollout stepped on ``device``) and the frames'
  noise from one ``torch.Generator`` seeded with ``config.seed``.

  With ``history`` a list, each step is synchronised and appended as
  ``{step, seconds, loss, events}``: host seconds from fetching its batch
  to the end of its events, and the events that fired.
  """
  return _Run(config, workdir, get_device(device)).prelim(history)


def train(config, workdir: str, *, device=None,
          history: Optional[List[Dict[str, Any]]] = None
          ) -> state_lib.TrainState:
  """Both phases of PINN training on ``device`` (default ``cuda``);
  returns phase 2's final train state.

  Phase 1 is :func:`train_prelim`'s, steps 0 .. ``training.n_iters``.
  Phase 2 follows the JAX ``train``: ``get_pinn_optimizer`` with the
  PressureNet's learning rate x 0.005; a fresh train state (fresh EMA and
  Adam counts) from phase 1's parameters, its step ``n_iters``; the
  preemption checkpoint ``workdir/checkpoints-meta/checkpoint_pinn``
  restored when present; then ``_run_phase``'s steps ``state.step`` ..
  ``n_iters + n_pinn_iters`` of :func:`losses.get_pinn_step_fn`, tag
  ``'pinn'``, snapshots into the same ``workdir/checkpoints``.  The masks,
  the data iterators and the noise generator carry on from phase 1, so
  step ``n_iters`` runs once in each phase, as in JAX.  A second call
  re-runs phase 1's steps after its preemption checkpoint, then phase 2
  from ``checkpoint_pinn``.  ``history`` as :func:`train_prelim`'s, each
  entry with its ``phase`` (``'prelim'`` or ``'pinn'``).
  """
  run = _Run(config, workdir, get_device(device))
  state = run.prelim(history)
  t = config.training
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.005)
  state = state_lib.create_train_state(state.params, tx,
                                       config.model.ema_rate)
  state.step = t.n_iters
  state = ckpt_lib.restore_checkpoint(run.checkpoint_pinn, state, quiet=True)
  logger.info('Starting Regularization Training loop at step %d.',
              state.step)
  return run.phase(state, pinn_losses.get_pinn_step_fn, tx,
                   t.n_iters + t.n_pinn_iters, run.checkpoint_pinn, 'pinn',
                   history)
