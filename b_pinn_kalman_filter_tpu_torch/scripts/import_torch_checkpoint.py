"""Import a reference PyTorch checkpoint into the port's workdir layout.

Counterpart of the JAX package's ``scripts/import_torch_checkpoint.py``.
Converts a ``checkpoint_N.pth`` that the reference trainer wrote
(reference utils.py:109-128) into the port's checkpoints:

    python -m b_pinn_kalman_filter_tpu_torch.scripts.import_torch_checkpoint \\
        --config b_pinn_kalman_filter_tpu_torch/configs/vp/cifar10_ddpmpp_continuous.py \\
        --torch_ckpt /path/to/checkpoint_10.pth --workdir ./migrated \\
        [--config.<section>.<key>=<value> ...]

It writes ``<workdir>/checkpoints-meta/checkpoint`` and
``<workdir>/checkpoints/checkpoint_<step // snapshot_freq>`` through
``train/checkpoint.py`` ``save_checkpoint``, so every mode takes the
imported weights as they are:

    python -m b_pinn_kalman_filter_tpu_torch --config ... --workdir ./migrated --mode train   # resume
    python -m b_pinn_kalman_filter_tpu_torch --config ... --mode sample --ckptdir ./migrated/checkpoints/checkpoint_<k>
    python -m b_pinn_kalman_filter_tpu_torch --config ... --workdir ./migrated --mode eval

A PINN checkpoint (``info == 0``) feeds ``--mode ukf --ckptdir`` and
``--mode train_bpinn --ckptdir`` (the MOPED bootstrap).  The payload's
``info`` picks the converter (``models/torch_port.py``): 0 the PINN's, 1
or absent the score model's, by ``config.model.name``.  The torch
optimizer moments are dropped for a fresh optimizer state.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from b_pinn_kalman_filter_tpu_torch.__main__ import (OVERRIDE, apply_overrides,
                                                     load_config)


def import_checkpoint(config, torch_ckpt: str, workdir: str) -> str:
  """Convert ``torch_ckpt`` for ``config`` and write it under
  ``workdir``; returns the numbered checkpoint's path."""
  from b_pinn_kalman_filter_tpu_torch.models import torch_port
  from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
  ckpt = torch_port.load(torch_ckpt)
  if ckpt.get('info', 1) == 0:
    state = torch_port.convert_reference_pinn_checkpoint(ckpt, config)
  else:
    state = torch_port.convert_reference_checkpoint(ckpt, config)
  meta_path = os.path.join(workdir, 'checkpoints-meta', 'checkpoint')
  ckpt_lib.save_checkpoint(meta_path, state)
  # Numbered as the train loop numbers its snapshots.
  save_step = state.step // max(1, config.training.snapshot_freq)
  num_path = os.path.join(workdir, 'checkpoints', f'checkpoint_{save_step}')
  ckpt_lib.save_checkpoint(num_path, state)
  logging.info('Imported the step-%d reference checkpoint:\n  %s\n  %s',
               state.step, meta_path, num_path)
  return num_path


def main(argv: Optional[List[str]] = None) -> int:
  parser = argparse.ArgumentParser(
      prog='python -m b_pinn_kalman_filter_tpu_torch.scripts.'
      'import_torch_checkpoint', description=__doc__.split('\n\n')[0])
  parser.add_argument('--config', required=True,
                      help='config file of the port')
  parser.add_argument('--torch_ckpt', required=True,
                      help='reference .pth checkpoint')
  parser.add_argument('--workdir', required=True,
                      help='destination work directory')
  args, rest = parser.parse_known_args(argv)
  stray = [a for a in rest if not a.startswith(OVERRIDE)]
  if stray:
    parser.error(f'unrecognized arguments: {" ".join(stray)}')
  config = load_config(args.config)
  apply_overrides(config, [a[len(OVERRIDE):] for a in rest])
  path = import_checkpoint(config, args.torch_ckpt, args.workdir)
  print(f'imported -> {path}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
