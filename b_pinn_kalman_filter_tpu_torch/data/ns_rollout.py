"""Synthetic Navier–Stokes rollouts, the ground truth of the UKF run.

The port's own copy of the JAX package's ``data/datasets.py``
``_smooth_field`` and of the stepping path of ``_generate_ns_rollout``
(velocity, pressure, density, then damping by 0.99, 0.99 and 0.95), here
stepped by the port's ``ns_step_fused`` (kernel K4 on the card, one launch
per frame).  The initial fields come from numpy with the seed, as there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.ops.ns_step import ns_step_fused


def smooth_field(rng: np.random.Generator, shape: Tuple[int, ...],
                 smoothness: int = 8) -> np.ndarray:
  """Smooth random field in [0, 1]: low-resolution noise, bilinearly
  upsampled, then scaled to [0, 1]."""
  h, w = shape[-2], shape[-1]
  lo = rng.standard_normal(shape[:-2] + (max(2, h // smoothness),
                                         max(2, w // smoothness)))
  ys = np.linspace(0, lo.shape[-2] - 1, h)
  xs = np.linspace(0, lo.shape[-1] - 1, w)
  y0 = np.floor(ys).astype(int)
  y1 = np.minimum(y0 + 1, lo.shape[-2] - 1)
  x0 = np.floor(xs).astype(int)
  x1 = np.minimum(x0 + 1, lo.shape[-1] - 1)
  wy = (ys - y0)[:, None]
  wx = (xs - x0)[None, :]
  a = lo[..., y0, :][..., :, x0]
  b = lo[..., y0, :][..., :, x1]
  c = lo[..., y1, :][..., :, x0]
  d = lo[..., y1, :][..., :, x1]
  out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx)
         + d * wy * wx)
  out = out - out.min(axis=(-2, -1), keepdims=True)
  denom = out.max(axis=(-2, -1), keepdims=True)
  return out / np.maximum(denom, 1e-8)


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
