"""Patch/unpatch between image fields and per-patch filter states.

Counterpart of the JAX package's ``kalman/patching.py``: ``patch`` maps
(B, H, W, C) to (C*B*N, p^2) with patches ordered (channel, batch,
row-block, col-block), and ``unpatch`` inverts it.  The channel is the
outermost axis of a state, so a stack of S states (S, C*B*N, p^2) is
unpatched as S images (:func:`unpatch_stack`), not as one (S*C*B*N, p^2)
array.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def patch(x: Tensor, p_size: int) -> Tensor:
  """(B, H, W, C) -> (C*B*N, p^2), N = (H/p)*(W/p)."""
  return patch_stack(x[None], p_size)[0]


def unpatch(x: Tensor, p_size: int, f_size: int,
            channel_num: int = 6) -> Tensor:
  """(C*B*N, p^2) -> (B, f_size, f_size, C)."""
  return unpatch_stack(x[None], p_size, f_size, channel_num)[0]


def patch_stack(x: Tensor, p_size: int) -> Tensor:
  """(S, B, H, W, C) -> (S, C*B*N, p^2): :func:`patch` of each of S
  images."""
  S, B, H, W, C = x.shape
  nh, nw = H // p_size, W // p_size
  x = x.permute(0, 4, 1, 2, 3)                    # (S, C, B, H, W)
  x = x.reshape(S, C, B, nh, p_size, nw, p_size)
  x = x.permute(0, 1, 2, 3, 5, 4, 6)              # (S, C, B, nh, nw, p, p)
  return x.reshape(S, -1, p_size * p_size)


def unpatch_stack(x: Tensor, p_size: int, f_size: int,
                  channel_num: int = 6) -> Tensor:
  """(S, C*B*N, p^2) -> (S, B, f_size, f_size, C): :func:`unpatch` of each
  of S states."""
  S = x.shape[0]
  num = f_size // p_size
  B = x.shape[1] // (num * num) // channel_num
  x = x.reshape(S, channel_num, B, num, num, p_size, p_size)
  x = x.permute(0, 2, 3, 5, 4, 6, 1)              # (S, B, nh, p, nw, p, C)
  return x.reshape(S, B, f_size, f_size, channel_num)
