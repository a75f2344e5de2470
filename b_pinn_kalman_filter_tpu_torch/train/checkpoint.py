"""Train-state checkpoints.

Counterpart of the JAX package's ``train/checkpoint.py``, with its
two-tier layout: numbered snapshots ``checkpoints/checkpoint_N`` and the
preemption checkpoint ``checkpoints-meta/checkpoint``, which the train
loop restores at start.  A checkpoint is one ``torch.save`` file of
``{step, params, opt_state: {count, mu, nu}, ema_params}`` (with the
groups of a ``MultiTransform``, ``opt_state: {label: {count, mu, nu}}``),
each tree a ``{flax name: tensor}`` dict (the PINN's names carry their
``flownet.`` or ``pressurenet.`` prefix), written to a temporary file and
renamed, so that a reader never sees half of one.
``restore_bpinn_checkpoint`` starts a B-PINN state from the B-PINN
preemption checkpoint or from a PINN checkpoint (the MOPED bootstrap).
The reference's ``.pth`` checkpoints are read, not written:
``models/torch_port.py`` converts them and
``scripts/import_torch_checkpoint.py`` writes them in this layout.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Dict, Optional

import torch

from b_pinn_kalman_filter_tpu_torch.pinn import bayes
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.train.state import (AdamState, TrainState,
                                                        create_train_state)


def _groups(opt_state) -> Dict[Optional[str], AdamState]:
  """``{label: AdamState}``; one ungrouped state under the label None."""
  return ({None: opt_state} if isinstance(opt_state, AdamState)
          else opt_state)


def save_checkpoint(path: str, state: TrainState) -> None:
  """Write ``state`` to ``path`` (overwriting it)."""
  groups = {label: dataclasses.asdict(s)
            for label, s in _groups(state.opt_state).items()}
  tree = dict(step=state.step, params=state.params,
              opt_state=groups.get(None, groups),
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
  groups = _groups(state.opt_state)
  saved_groups = ({None: tree['opt_state']} if 'mu' in tree['opt_state']
                  else tree['opt_state'])
  if saved_groups.keys() != groups.keys():
    raise ValueError(f'{path}: optimizer groups '
                     f'{sorted(map(str, saved_groups))} differ from the '
                     f'state\'s {sorted(map(str, groups))}')
  pairs = [('params', tree['params'], state.params),
           ('ema_params', tree['ema_params'], state.ema_params)]
  for label, group in groups.items():
    saved = saved_groups[label]
    pairs += [(f'mu {label}', saved['mu'], group.mu),
              (f'nu {label}', saved['nu'], group.nu)]
  with torch.no_grad():
    for what, saved, into in pairs:
      if saved.keys() != into.keys():
        raise ValueError(f'{path}: {what} names differ from the model\'s: '
                         f'{sorted(set(saved) ^ set(into))[:5]}')
      for name, value in saved.items():
        if value.shape != into[name].shape:
          raise ValueError(f'{path}: {what} {name} has shape '
                           f'{tuple(value.shape)}, the model '
                           f'{tuple(into[name].shape)}')
        into[name].copy_(value)
  opt_state = {label: AdamState(count=int(saved_groups[label]['count']),
                                mu=group.mu, nu=group.nu)
               for label, group in groups.items()}
  return dataclasses.replace(state, step=int(tree['step']),
                             opt_state=opt_state.get(None, opt_state))


def restore_bpinn_checkpoint(pinn_ckpt_dir: Optional[str], meta_dir: str,
                             bpinn_state: TrainState, config) -> TrainState:
  """The B-PINN state at the start of its training: the B-PINN preemption
  checkpoint ``meta_dir`` when it exists; else, when the PINN checkpoint
  ``pinn_ckpt_dir`` exists, the MOPED posterior around its ``ema_params``
  (mu the weights, rho ``inv_softplus(delta |w|)``), copied into both the
  params and the EMA of ``bpinn_state`` (its Adam state and step as they
  were); else ``bpinn_state`` as it is.  ``bpinn_state.params`` is the
  flat posterior of ``pinn/bayes.py``."""
  if os.path.exists(meta_dir):
    return restore_checkpoint(meta_dir, bpinn_state)
  if not (pinn_ckpt_dir and os.path.exists(pinn_ckpt_dir)):
    return bpinn_state
  posterior = bayes.nest_posterior(bpinn_state.params)
  template = create_train_state(
      {f'{key}.{name}': mu.detach().clone() for key in posterior
       for name, mu in posterior[key]['mu'].items()},
      pinn_losses.get_pinn_optimizer(config), config.model.ema_rate)
  pinn_params = restore_checkpoint(pinn_ckpt_dir, template).ema_params
  moped = bayes.flatten_posterior(bayes.make_bpinn_params(
      bayes.by_key(pinn_params), config, pretrained=True))
  with torch.no_grad():
    for name, value in moped.items():
      bpinn_state.params[name].copy_(value)
      bpinn_state.ema_params[name].copy_(value)
  return bpinn_state


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
