"""Bilinear grid sampling as gather + lerp, NHWC.

Counterpart of the JAX package's ``ops/grid_sample.py``.  Written in plain
torch ops, not as a kernel, so that autograd composes to any order: PINN
losses differentiate twice through the warp.

Conventions follow ``F.grid_sample``: grid values in [-1, 1],
``grid[..., 0]`` indexes width (x) and ``grid[..., 1]`` height (y);
``padding_mode`` 'zeros' or 'border'; ``align_corners`` True or False.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _unnormalize(coord: Tensor, size: int, align_corners: bool) -> Tensor:
  if align_corners:
    return (coord + 1.0) / 2.0 * (size - 1)
  return ((coord + 1.0) * size - 1.0) / 2.0


def grid_sample_2d(input: Tensor, grid: Tensor, padding_mode: str = 'zeros',
                   align_corners: bool = True) -> Tensor:
  """Bilinear sample: input (B, H, W, C), grid (B, Ho, Wo, 2) ->
  (B, Ho, Wo, C)."""
  if padding_mode not in ('zeros', 'border'):
    raise ValueError(f'unknown padding_mode {padding_mode!r}')
  B, H, W, C = input.shape
  x = _unnormalize(grid[..., 0], W, align_corners)
  y = _unnormalize(grid[..., 1], H, align_corners)

  x0 = torch.floor(x)
  y0 = torch.floor(y)
  x1, y1 = x0 + 1, y0 + 1
  wx = (x - x0)[..., None]
  wy = (y - y0)[..., None]
  batch = torch.arange(B, device=input.device)[:, None, None]

  def gather(ix, iy):
    ix_c = ix.clamp(0, W - 1).long()
    iy_c = iy.clamp(0, H - 1).long()
    vals = input[batch, iy_c, ix_c]                  # (B, Ho, Wo, C)
    if padding_mode == 'zeros':
      valid = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
      vals = vals * valid[..., None].to(vals.dtype)
    return vals

  top = gather(x0, y0) * (1 - wx) + gather(x1, y0) * wx
  bot = gather(x0, y1) * (1 - wx) + gather(x1, y1) * wx
  return top * (1 - wy) + bot * wy


def make_normalized_grid(B: int, H: int, W: int, dtype=torch.float32,
                         device=None) -> Tensor:
  """Identity sampling grid in [-1, 1], (B, H, W, 2) in (x, y) order."""
  xs = torch.linspace(-1.0, 1.0, W, dtype=dtype, device=device)
  ys = torch.linspace(-1.0, 1.0, H, dtype=dtype, device=device)
  gy, gx = torch.meshgrid(ys, xs, indexing='ij')     # (H, W)
  return torch.stack([gx, gy], dim=-1).expand(B, H, W, 2)
