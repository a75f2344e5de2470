"""Train-state checkpoints.

Counterpart of the JAX package's ``train/checkpoint.py``, with its
two-tier layout: numbered snapshots ``checkpoints/checkpoint_N`` and the
preemption checkpoint ``checkpoints-meta/checkpoint``, which the train
loop restores at start.  A checkpoint is one ``torch.save`` file of
``{step, params, opt_state: {count, mu, nu}, ema_params}``, each tree a
``{flax name: tensor}`` dict, written to a temporary file and renamed, so
that a reader never sees half of one.  (The reference's ``.pth`` layout,
which the JAX importers read, is ROADMAP.md A.14.)
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Optional

import torch

from b_pinn_kalman_filter_tpu_torch.train.state import AdamState, TrainState


def save_checkpoint(path: str, state: TrainState) -> None:
  """Write ``state`` to ``path`` (overwriting it)."""
  tree = dict(step=state.step, params=state.params,
              opt_state=dataclasses.asdict(state.opt_state),
              ema_params=state.ema_params)
  directory = os.path.dirname(os.path.abspath(path))
  os.makedirs(directory, exist_ok=True)
  fd, tmp = tempfile.mkstemp(dir=directory, suffix='.tmp')
  os.close(fd)
  try:
    torch.save({k: _detached(v) for k, v in tree.items()}, tmp)
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)


def _detached(value):
  if isinstance(value, dict):
    return {k: _detached(v) for k, v in value.items()}
  return value.detach() if isinstance(value, torch.Tensor) else value


def restore_checkpoint(path: str, state: TrainState,
                       quiet: bool = False) -> TrainState:
  """``state`` with every tensor, the count and the step read from
  ``path``, the tensors copied in place onto the template's devices;
  ``state`` unchanged when ``path`` does not exist.  Raises
  ``ValueError`` where the saved names or shapes differ from the
  template's."""
  if not os.path.exists(path):
    if not quiet:
      logging.warning('No checkpoint found at %s. Returned the same state '
                      'as input', path)
    return state
  tree = torch.load(path, map_location='cpu', weights_only=True)
  opt = tree['opt_state']
  with torch.no_grad():
    for what, saved, into in (
        ('params', tree['params'], state.params),
        ('mu', opt['mu'], state.opt_state.mu),
        ('nu', opt['nu'], state.opt_state.nu),
        ('ema_params', tree['ema_params'], state.ema_params)):
      if saved.keys() != into.keys():
        raise ValueError(f'{path}: {what} names differ from the model\'s: '
                         f'{sorted(set(saved) ^ set(into))[:5]}')
      for name, value in saved.items():
        if value.shape != into[name].shape:
          raise ValueError(f'{path}: {what} {name} has shape '
                           f'{tuple(value.shape)}, the model '
                           f'{tuple(into[name].shape)}')
        into[name].copy_(value)
  return dataclasses.replace(
      state, step=int(tree['step']),
      opt_state=AdamState(count=int(opt['count']), mu=state.opt_state.mu,
                          nu=state.opt_state.nu))


def latest_checkpoint_step(checkpoint_dir: str) -> Optional[int]:
  """Highest N among ``checkpoint_N`` under ``checkpoint_dir``."""
  if not os.path.isdir(checkpoint_dir):
    return None
  steps = []
  for name in os.listdir(checkpoint_dir):
    if name.startswith('checkpoint_'):
      try:
        steps.append(int(name.split('_')[-1]))
      except ValueError:
        pass
  return max(steps) if steps else None
