"""StyleGAN2-style FIR resampling on :func:`upfirdn2d`, NHWC, and the
``Conv2d`` module that fuses it with a convolution.

Counterpart of the JAX package's ``ops/resample.py``.  Every op here is a
library call (cuDNN on the card), as in JAX, where XLA computes them
outside any Pallas kernel.  Weights are HWIO, as flax keeps them; each op
computes in ``x.dtype``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.ops.upfirdn2d import (
    setup_kernel, upfirdn2d, zero_stuff)

Tensor = torch.Tensor


naive_upsample_2d = layers.naive_upsample_2d


def naive_downsample_2d(x: Tensor, factor: int = 2) -> Tensor:
  """Mean over each ``factor`` x ``factor`` patch."""
  B, H, W, C = x.shape
  x = x.reshape(B, H // factor, factor, W // factor, factor, C)
  return x.mean(dim=(2, 4))


def _kernel(k: Optional[Sequence], factor: int, gain: float):
  return setup_kernel([1] * factor if k is None else k) * gain


def upsample_2d(x: Tensor, k: Optional[Sequence] = None, factor: int = 2,
                gain: float = 1.0) -> Tensor:
  """FIR upsample by ``factor``."""
  assert isinstance(factor, int) and factor >= 1
  k = _kernel(k, factor, gain * factor ** 2)
  p = k.shape[0] - factor
  return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: Tensor, k: Optional[Sequence] = None, factor: int = 2,
                  gain: float = 1.0) -> Tensor:
  """FIR downsample by ``factor``."""
  assert isinstance(factor, int) and factor >= 1
  k = _kernel(k, factor, gain)
  p = k.shape[0] - factor
  return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def _oihw(w: Tensor, dtype: torch.dtype) -> Tensor:
  return w.to(dtype).permute(3, 2, 0, 1)


def upsample_conv_2d(x: Tensor, w: Tensor, k: Optional[Sequence] = None,
                     factor: int = 2, gain: float = 1.0) -> Tensor:
  """Transposed conv of stride ``factor`` then the FIR filter; ``w`` is
  HWIO.

  JAX takes ``lax.conv_transpose(..., padding='VALID',
  transpose_kernel=False)``: the input dilated by ``factor``, padded by
  ``kh - 1`` before and ``factor - 1 + max(kh - factor, 0)`` after, then
  *correlated* with ``w`` as it stands.  ``F.conv_transpose2d`` would
  flip the kernel and swap its channel axes, so the port zero-stuffs and
  calls ``F.conv2d`` with ``w`` itself.
  """
  assert isinstance(factor, int) and factor >= 1
  kh, kw, _, _ = w.shape
  assert kh == kw
  k = _kernel(k, factor, gain * factor ** 2)
  p = (k.shape[0] - factor) - (kw - 1)
  # zero_stuff keeps factor - 1 trailing zeros of the dilation's padding.
  pad_a, pad_b = kw - 1, max(kw - factor, 0)
  h = F.pad(zero_stuff(x, factor), (0, 0, pad_a, pad_b, pad_a, pad_b))
  h = F.conv2d(h.permute(0, 3, 1, 2), _oihw(w, x.dtype))
  h = h.permute(0, 2, 3, 1)
  return upfirdn2d(h, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: Tensor, w: Tensor, k: Optional[Sequence] = None,
                       factor: int = 2, gain: float = 1.0) -> Tensor:
  """The FIR filter then a VALID conv of stride ``factor``; ``w`` is
  HWIO."""
  assert isinstance(factor, int) and factor >= 1
  kh, kw, _, _ = w.shape
  assert kh == kw
  k = _kernel(k, factor, gain)
  p = (k.shape[0] - factor) + (kw - 1)
  h = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
  h = F.conv2d(h.permute(0, 3, 1, 2), _oihw(w, x.dtype), stride=factor)
  return h.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Module):
  """A ``kernel`` x ``kernel`` conv with optional fused FIR up- or
  downsampling by 2 (flax ``resample.Conv2d``: ``weight`` HWIO, ``bias``),
  in ``x.dtype``.  ``init`` fills ``weight`` (the layers' ``default_init``
  from NCSN++; zeros by default, as in JAX)."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int, up: bool = False,
               down: bool = False,
               resample_kernel: Sequence[int] = (1, 3, 3, 1),
               use_bias: bool = True, init=None):
    super().__init__()
    assert not (up and down)
    assert kernel >= 1 and kernel % 2 == 1
    self.up, self.down = up, down
    self.resample_kernel = tuple(resample_kernel)
    self.use_bias = use_bias
    layers._param(self, 'weight', (kernel, kernel, in_ch, out_ch),
                  init or layers.zeros_init)
    if use_bias:
      layers._param(self, 'bias', (out_ch,), layers.zeros_init)

  def forward(self, x):
    if self.up:
      x = upsample_conv_2d(x, self.weight, k=self.resample_kernel)
    elif self.down:
      x = conv_downsample_2d(x, self.weight, k=self.resample_kernel)
    else:
      pad = self.weight.shape[0] // 2
      x = F.conv2d(x.permute(0, 3, 1, 2), _oihw(self.weight, x.dtype),
                   padding=pad).permute(0, 2, 3, 1).contiguous()
    if self.use_bias:
      x = x + self.bias.to(x.dtype)
    return x
