"""Autoregressive simulators: the PINN rollout and the NS stepper's rollout,
and the ``simulate`` entry point.

Counterpart of the JAX package's ``kalman/simulator.py`` (``simulate``,
``step_rollout``, ``run``).  The stepper is the port's ``ns_step_fused``:
kernel K4 on the card, one launch a frame (the JAX ``ns_step_auto`` runs
XLA off the TPU; the port has no such fallback), and its plain version on
the CPU.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from b_pinn_kalman_filter_tpu_torch.data.ns_rollout import ns_rollout
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.ops.ns_step import ns_step_fused
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import pinn_step
from b_pinn_kalman_filter_tpu_torch.utils.misc import save_image_grid

logger = logging.getLogger(__name__)

Tensor = torch.Tensor
DT = 0.0005 * 5     # the reference simulator's time step
DX = 1.0 / 200      # and grid spacing (not the rollout's 1 / max(h, w))


@torch.no_grad()
def simulate(model, params, config, begin: Tensor, t_range=(0, 100),
             stride: int = 1) -> Tuple[List[Tensor], List[Tensor]]:
  """Autoregressive PINN rollout: the PINN's flow from the last two
  frames advects the last one, which then feeds back.

  ``begin`` (T, 6, H, W) ground-truth frames (coordx, coordy, f, u, v, p)
  on the model's device; ``params`` the PINN's flat parameters
  (``{'flownet.<name>': ...}``), or None for the module's own.  Frame
  ``t`` of ``range(*t_range, stride)`` runs the PINN with time ``t`` on
  the frames ``begin[t0]`` and ``begin[t0 + 1]`` at first, its own
  outputs after.  Returns (advected frames (1, H, W, 1), flows (1, H, W,
  2)), one each a frame.
  """
  def prep(d):
    return d[None, :, :, None]

  t0, tm = t_range
  f1, f2 = prep(begin[t0, 2]), prep(begin[t0 + 1, 2])
  x, y = prep(begin[t0, 0]), prep(begin[t0, 1])
  size = (config.data.image_size, config.data.image_size)
  result, vel = [], []
  for t in range(t0, tm, stride):
    tt = torch.full((1,), float(t), device=begin.device)
    args = (f1, f2, x, y, tt)
    if params is None:
      flow, _ = model(*args, size=size)
    else:
      flow, _ = functional_call(model, params, args, {'size': size},
                                strict=True)
    f = pinn_step(f2, flow[-1], config.data.dt)
    result.append(f)
    vel.append(flow[-1])
    f1, f2 = f2, f
  return result, vel


@torch.no_grad()
def step_rollout(begin: Tensor, t_range=(0, 100), stride: int = 1,
                 batch: int = 1):
  """The NS stepper's rollout from frame ``t_range[0]`` of ``begin`` (T,
  6, H, W), ``batch`` copies, one ``ns_step_fused`` (DT, DX) a frame of
  ``range(*t_range, stride)``.  Returns (densities, velocities (u, v),
  pressures), one each a frame, each (batch, H, W)."""
  t0, tm = t_range

  def prep(d):
    return d[None].repeat(batch, 1, 1)

  f, u, v, p = (prep(begin[t0, c]) for c in range(2, 6))
  result, vels, press = [], [], []
  for _ in range(t0, tm, stride):
    f, u, v, p = ns_step_fused(f, u, v, p, DT, DX)
    result.append(f)
    vels.append((u, v))
    press.append(p)
  return result, vels, press


def run(config, ckptdir: Optional[str], workdir: str, n_steps: int = 100,
        device=None) -> List[float]:
  """The ``simulate`` entry point: the NS stepper's rollout from frame 0
  of a synthetic rollout (``ns_rollout``, ``max(n_steps + 2, 64)`` frames
  at the config's image size from ``config.seed``) against its frames, on
  ``device`` (default ``cuda``).

  Writes ``simulate_mse.txt`` (each step's density MSE against the next
  ground-truth frame, one a line) and ``simulate.png`` (about ten of the
  rollout's densities in a row, clipped to [0, 1]) into ``workdir``;
  returns the MSEs.  ``ckptdir`` is not read: the JAX ``run`` takes it and
  ignores it too.
  """
  del ckptdir
  device = get_device(device)
  os.makedirs(workdir, exist_ok=True)
  size = config.data.image_size
  data = ns_rollout(max(n_steps + 2, 64), size, size, config.seed,
                    device=device)
  result, _, _ = step_rollout(data, t_range=(0, n_steps))
  n = min(len(result), len(data) - 1)
  sim = torch.stack([f[0] for f in result[:n]])
  mses = torch.mean((sim - data[1:n + 1, 2]) ** 2, dim=(1, 2)).tolist()
  logger.info('simulate: %d steps, final f MSE vs gt: %.5e', n_steps,
              mses[-1] if mses else float('nan'))
  frames = torch.stack([result[i][0] for i in
                        range(0, len(result), max(1, len(result) // 10))])
  save_image_grid(np.clip(frames.cpu().numpy()[..., None], 0, 1),
                  os.path.join(workdir, 'simulate.png'), nrow=len(frames))
  with open(os.path.join(workdir, 'simulate_mse.txt'), 'w') as fh:
    for m in mses:
      fh.write(f'{m}\n')
  return mses
