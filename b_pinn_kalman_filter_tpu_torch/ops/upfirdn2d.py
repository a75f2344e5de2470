"""upfirdn2d: zero-stuff by ``up``, pad (negative: crop), filter with a
2-D FIR kernel, keep every ``down``-th sample.  NHWC.

Counterpart of the JAX package's ``ops/upfirdn2d.py``, which computes the
whole op as one ``lax.conv_general_dilated`` (XLA's convolution, no Pallas
kernel).  Here it is one depthwise ``F.conv2d`` (cuDNN on the card) over
the zero-stuffed, padded input, with the flipped kernel and stride
``down``: convolving with the kernel is correlating with its flip.
Autograd differentiates it.  :func:`upfirdn2d_ref` is the literal
algorithm, step by step, kept for the tests.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def setup_kernel(k) -> np.ndarray:
  """A 1-D (separable) or 2-D FIR kernel as a square 2-D float32 array
  that sums to 1."""
  k = np.asarray(k, dtype=np.float32)
  if k.ndim == 1:
    k = np.outer(k, k)
  k = k / np.sum(k)
  assert k.ndim == 2 and k.shape[0] == k.shape[1]
  return k


@functools.lru_cache(maxsize=None)
def _depthwise_weight(data: bytes, shape: Tuple[int, int], channels: int,
                      dtype: torch.dtype, device: torch.device
                      ) -> torch.Tensor:
  """The flipped kernel repeated over ``channels``, (C, 1, kh, kw), made
  once for each kernel, width, dtype and device; a normal tensor even when
  first made under ``torch.inference_mode``, so that autograd may save it
  later."""
  k = np.frombuffer(data, np.float32).reshape(shape)[::-1, ::-1].copy()
  with torch.inference_mode(False):
    w = torch.from_numpy(k).to(device=device, dtype=dtype)
    return w.expand(channels, 1, *shape).contiguous()


def zero_stuff(x: torch.Tensor, up: int) -> torch.Tensor:
  """(B, H, W, C) -> (B, H * up, W * up, C): each pixel followed by
  ``up - 1`` zeros along H and W."""
  if up == 1:
    return x
  B, H, W, C = x.shape
  out = x.new_zeros((B, H * up, W * up, C))
  out[:, ::up, ::up] = x
  return out


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
  """Upsample, FIR-filter and downsample an NHWC batch in ``x.dtype``.

  ``kernel`` is a 2-D array (:func:`setup_kernel`'s); ``pad = (p0, p1)`` pads
  (or, negative, crops) both spatial axes of the zero-stuffed image, whose
  trailing ``up - 1`` zeros are kept, as in the reference.
  """
  B, H, W, C = x.shape
  p0, p1 = pad
  h = F.pad(zero_stuff(x, up), (0, 0, p0, p1, p0, p1))
  k = np.ascontiguousarray(kernel, dtype=np.float32)
  w = _depthwise_weight(k.tobytes(), k.shape, C, x.dtype, x.device)
  out = F.conv2d(h.permute(0, 3, 1, 2), w, stride=down, groups=C)
  return out.permute(0, 2, 3, 1).contiguous()


def upfirdn2d_ref(x: torch.Tensor, kernel, up_x: int = 1, up_y: int = 1,
                  down_x: int = 1, down_y: int = 1, pad_x0: int = 0,
                  pad_x1: int = 0, pad_y0: int = 0, pad_y1: int = 0
                  ) -> torch.Tensor:
  """The algorithm step by step (the tests' reference): zero-stuff, pad
  then crop, convolve channel by channel, subsample."""
  B, in_h, in_w, C = x.shape
  kernel = torch.as_tensor(np.asarray(kernel, np.float32), dtype=x.dtype,
                           device=x.device)
  kh, kw = kernel.shape

  out = x.reshape(B, in_h, 1, in_w, 1, C)
  out = F.pad(out, (0, 0, 0, up_x - 1, 0, 0, 0, up_y - 1))
  out = out.reshape(B, in_h * up_y, in_w * up_x, C)

  out = F.pad(out, (0, 0, max(pad_x0, 0), max(pad_x1, 0),
                    max(pad_y0, 0), max(pad_y1, 0)))
  out = out[:, max(-pad_y0, 0): out.shape[1] - max(-pad_y1, 0),
            max(-pad_x0, 0): out.shape[2] - max(-pad_x1, 0), :]

  w = kernel.flip(0, 1)
  rows = []
  for c in range(C):
    plane = out[:, None, :, :, c]
    rows.append(F.conv2d(plane, w[None, None])[:, 0])
  out = torch.stack(rows, dim=-1)

  out = out[:, ::down_y, ::down_x, :]
  out_h = (in_h * up_y + pad_y0 + pad_y1 - kh) // down_y + 1
  out_w = (in_w * up_x + pad_x0 + pad_x1 - kw) // down_x + 1
  assert out.shape == (B, out_h, out_w, C)
  return out
