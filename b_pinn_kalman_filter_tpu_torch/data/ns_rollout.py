"""Synthetic Navier–Stokes rollouts, the ground truth of the UKF run and
the frames of the PDE dataset.

The port's own copy of the stepping path of the JAX package's
``data/datasets.py`` ``_generate_ns_rollout``
(velocity, pressure, density, then damping by 0.99, 0.99 and 0.95), here
stepped by the port's ``ns_step_fused`` (kernel K4 on the card, one launch
per frame).  The initial fields come from numpy with the seed, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.data.datasets import smooth_field
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.ops.ns_step import ns_step_fused


@torch.no_grad()
def ns_rollout(n_frames: int, h: int, w: int, seed: int = 0,
               device=None) -> torch.Tensor:
  """Rollout (T, 6, H, W) float32 on ``device`` (default ``cuda``): the
  channels are coordx, coordy, density, u, v, p.  Frame 0 is the initial
  state; each later frame is one damped NS step of the one before."""
  device = get_device(device)
  rng = np.random.default_rng(seed)
  coordx, coordy = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
  density = smooth_field(rng, (h, w), 6)
  u = (smooth_field(rng, (h, w), 8) - 0.5).astype(np.float32) * 2.0
  v = (smooth_field(rng, (h, w), 8) - 0.5).astype(np.float32) * 2.0
  state = [torch.as_tensor(a, dtype=torch.float32, device=device)[None]
           for a in (density, u, v, np.zeros((h, w)))]
  coords = torch.as_tensor(np.stack([coordx, coordy]), dtype=torch.float32,
                           device=device)
  dt, dx = 0.0025, 1.0 / max(h, w)

  frames = torch.empty((n_frames, 6, h, w), dtype=torch.float32,
                       device=device)
  for i in range(n_frames):
    frames[i, :2] = coords
    frames[i, 2:] = torch.cat(state)
    if i + 1 < n_frames:
      d_, u_, v_, p_ = ns_step_fused(*state, dt, dx)
      state = [d_, u_ * 0.99, v_ * 0.99, p_ * 0.95]
  return frames
