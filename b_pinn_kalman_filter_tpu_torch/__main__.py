"""The port's command line, with the JAX package's ``main.py`` surface:

    python -m b_pinn_kalman_filter_tpu_torch --config <config .py>
        --workdir <dir> --mode <mode> [--ckptdir <dir>]
        [--eval_folder <name>] [--device cuda|cpu]
        [--config.<section>.<key>=<value> ...]

``--config`` is a file of the port's configs (for example
``b_pinn_kalman_filter_tpu_torch/configs/pinn/pinn_pde.py``) whose
``get_config()`` gives the ``ConfigDict``.  Each override names a key that
the config has; its value is read as a Python literal where it is one
(``5``, ``1e-3``, ``(4, 8)``), else kept as the string.  ``--device``
(default ``cuda``) is the entry points' device: ``cpu`` runs them on the
CPU.  Every mode runs the port's entry point: ``train``, ``sample`` (from
the checkpoint ``--ckptdir``, writing ``<workdir>/sample.png``), ``eval``
(the checkpoints under ``<workdir>/checkpoints``, into
``<workdir>/<eval_folder>``), ``inverse``, ``train_pinn``,
``train_bpinn``, ``simulate`` and ``ukf``; the training modes also log to
``<workdir>/stdout.txt``.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import logging
import os
import sys
from typing import List, Optional, Sequence

MODES = ('train', 'sample', 'eval', 'inverse', 'train_pinn', 'train_bpinn',
         'simulate', 'ukf')
OVERRIDE = '--config.'


def load_config(path: str):
  """``get_config()`` of the config file at ``path``."""
  spec = importlib.util.spec_from_file_location('_port_config', path)
  if spec is None or spec.loader is None:
    raise FileNotFoundError(f'no config file at {path}')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.get_config()


def _literal(raw: str):
  try:
    return ast.literal_eval(raw)
  except (ValueError, SyntaxError):
    return raw


def apply_overrides(config, overrides: Sequence[str]) -> None:
  """Set each ``<section>.<key>=<value>`` (the ``--config.`` prefix taken
  off) in ``config``; raises ``ValueError`` where the key is not in it."""
  for item in overrides:
    path, sep, raw = item.partition('=')
    if not sep:
      raise ValueError(f'override {item!r} has no "=<value>"')
    *parents, key = path.split('.')
    node = config
    for name in parents:
      if not isinstance(node, dict) or name not in node:
        raise ValueError(f'config has no {path!r}')
      node = node[name]
    if not isinstance(node, dict) or key not in node:
      raise ValueError(f'config has no {path!r}')
    node[key] = _literal(raw)


def parse_args(argv: Optional[Sequence[str]] = None):
  """(the parsed flags, the config overrides without their prefix)."""
  parser = argparse.ArgumentParser(
      prog='python -m b_pinn_kalman_filter_tpu_torch',
      description=__doc__.split('\n\n')[0])
  parser.add_argument('--config', required=True,
                      help='config file of the port')
  parser.add_argument('--workdir', required=True, help='work directory')
  parser.add_argument('--mode', required=True, choices=MODES)
  parser.add_argument('--ckptdir', default=None, help='checkpoint path')
  parser.add_argument('--eval_folder', default='eval',
                      help='folder of the eval results under the workdir')
  parser.add_argument('--device', default='cuda',
                      help='device of the entry points (default cuda)')
  args, rest = parser.parse_known_args(argv)
  stray = [a for a in rest if not a.startswith(OVERRIDE)]
  if stray:
    parser.error(f'unrecognized arguments: {" ".join(stray)}')
  return args, [a[len(OVERRIDE):] for a in rest]


def setup_logging(workdir: str) -> logging.Handler:
  """Log INFO and above of every logger to ``<workdir>/stdout.txt``."""
  os.makedirs(workdir, exist_ok=True)
  handler = logging.FileHandler(os.path.join(workdir, 'stdout.txt'), 'w')
  handler.setFormatter(logging.Formatter(
      '%(levelname)s - %(filename)s - %(asctime)s - %(message)s'))
  root = logging.getLogger()
  root.addHandler(handler)
  root.setLevel('INFO')
  return handler


def run(args, config) -> None:
  """Run ``args.mode`` on ``config``."""
  if args.mode in ('sample', 'eval'):
    from b_pinn_kalman_filter_tpu_torch.train import run_lib
    if args.mode == 'sample':
      run_lib.sample_from_checkpoint(config, args.ckptdir, args.workdir,
                                     device=args.device)
    else:
      run_lib.evaluate(config, args.workdir, args.eval_folder,
                       device=args.device)
    return
  if args.mode == 'simulate':
    from b_pinn_kalman_filter_tpu_torch.kalman import simulator
    simulator.run(config, args.ckptdir, args.workdir, device=args.device)
    return
  if args.mode == 'ukf':
    from b_pinn_kalman_filter_tpu_torch.kalman import ukf_lib
    ukf_lib.run(config, args.workdir, device=args.device,
                ckptdir=args.ckptdir)
    return
  if args.mode == 'inverse':
    from b_pinn_kalman_filter_tpu_torch.inverse import inverse_lib
    inverse_lib.inverse(config, args.ckptdir, args.workdir,
                        device=args.device)
    return
  handler = setup_logging(args.workdir)
  try:
    if args.mode == 'train':
      from b_pinn_kalman_filter_tpu_torch.train import run_lib
      run_lib.train(config, args.workdir, device=args.device)
    elif args.mode == 'train_pinn':
      from b_pinn_kalman_filter_tpu_torch.pinn import pinn_lib
      pinn_lib.train(config, args.workdir, device=args.device)
    else:
      from b_pinn_kalman_filter_tpu_torch.pinn import pinn_lib
      pinn_lib.train_bpinn(config, args.workdir, args.ckptdir,
                           device=args.device)
  finally:
    logging.getLogger().removeHandler(handler)
    handler.close()


def main(argv: Optional[List[str]] = None) -> int:
  args, overrides = parse_args(argv)
  config = load_config(args.config)
  apply_overrides(config, overrides)
  run(args, config)
  return 0


if __name__ == '__main__':
  sys.exit(main())
