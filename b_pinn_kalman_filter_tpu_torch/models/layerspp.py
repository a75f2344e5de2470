"""Layers of NCSN++ in PyTorch, NHWC.

Counterpart of the JAX package's ``models/layerspp.py``.  Each class
carries its flax class's name and its children the flax names
(``GroupNorm_0``, ``Conv3x3_0``, ``Dense_0``, ``Conv1x1_0``, ``NIN_0``,
``Conv2d_0``, ...), so ``convert.params_from_jax`` copies a tree name for
name.  The two kernel sites are those of the DDPM: the resblocks'
``act(GroupNorm)`` (:func:`norm_act`, kernel K2 with ``kernels=True``)
and their ``Conv3x3`` (kernel K1 where ``ops/conv3x3.py`` ``applicable``
holds).  The FIR resampling, the 1x1 and strided convs and the attention
stay library calls, as they stay XLA's in JAX, and so do the plain
GroupNorms (:func:`gn`): the attention's and the output pyramid's.

Dtypes follow JAX's promotion: a module with ``dtype`` computes in it,
one without computes in f32 (flax's ``Conv3x3`` and ``Conv1x1`` default),
and a sum rescaled by ``1 / sqrt(2)`` comes out in f32 (:func:`skip_sum`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as conv_ops
from b_pinn_kalman_filter_tpu_torch.ops import resample

Tensor = torch.Tensor


def num_groups(channels: int) -> int:
  """NCSN++'s group count, ``max(min(C // 4, 32), 1)``: the DDPM's
  ``min(32, C)`` from C = 128 up, fewer groups below."""
  return max(min(channels // 4, 32), 1)


def gn(channels: int, dtype: Optional[torch.dtype] = torch.float32
       ) -> layers.GroupNorm:
  """A plain GroupNorm (JAX ``_gn``), in ``dtype`` (None: the input's)."""
  return layers.GroupNorm(channels, num_groups(channels), dtype=dtype)


def norm_act(channels: int, act: Callable, dtype: torch.dtype,
             kernels: bool = True) -> layers.GroupNorm:
  """``act(GroupNorm(x))`` with NCSN++'s group count (JAX ``_norm_act``):
  kernel K2 where ``act`` is fusable and ``kernels``."""
  return layers.GroupNorm(channels, num_groups(channels), dtype=dtype,
                          act=act, kernels=kernels)


def skip_sum(x: Tensor, h: Tensor, skip_rescale: bool) -> Tensor:
  """``x + h``, or ``(x + h) / sqrt(2)``.  JAX divides by a numpy scalar,
  which is not weakly typed, so the rescaled sum is f32 even where ``x``
  and ``h`` are bf16."""
  s = x + h
  if not skip_rescale:
    return s
  return s.to(torch.promote_types(s.dtype, torch.float32)) / math.sqrt(2.0)


class GaussianFourierProjection(nn.Module):
  """Gaussian Fourier features of the log noise level: a fixed random
  projection ``W`` (N(0, scale^2) at init), a parameter as in flax but
  outside the graph (JAX ``stop_gradient``), so its gradient is zero."""

  def __init__(self, embedding_size: int = 256, scale: float = 1.0):
    super().__init__()

    def init(shape, generator):
      return torch.randn(tuple(shape), generator=generator) * scale

    layers._param(self, 'W', (embedding_size,), init)

  def forward(self, x):
    W = self.W.detach()
    x_proj = x[:, None] * W[None, :] * 2 * np.pi
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class Combine(nn.Module):
  """A pyramid level into the features: a 1x1 conv (f32) of ``x`` to
  ``dim2`` channels, then concatenated with (``'cat'``) or added to
  (``'sum'``) ``y``."""

  def __init__(self, in_ch: int, dim2: int, method: str = 'cat'):
    super().__init__()
    if method not in ('cat', 'sum'):
      raise ValueError(f'Method {method} not recognized.')
    self.method = method
    self.Conv1x1_0 = layers.Conv1x1(in_ch, dim2)

  def forward(self, x, y):
    h = self.Conv1x1_0(x)
    if self.method == 'cat':
      return torch.cat([h, y], dim=-1)
    return h + y


class AttnBlockpp(nn.Module):
  """Self-attention as (B, HW, C) batched products, both in f32 (JAX
  ``preferred_element_type``); its GroupNorm plain, from f32 statistics of
  the input, out in ``dtype``."""

  def __init__(self, channels: int, skip_rescale: bool = False,
               init_scale: float = 0.,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.skip_rescale = skip_rescale
    self.GroupNorm_0 = gn(channels, dtype=None)
    self.NIN_0 = layers.NIN(channels, channels, dtype=dtype)
    self.NIN_1 = layers.NIN(channels, channels, dtype=dtype)
    self.NIN_2 = layers.NIN(channels, channels, dtype=dtype)
    self.NIN_3 = layers.NIN(channels, channels, init_scale=init_scale,
                            dtype=dtype)

  def forward(self, x):
    B, H, W, C = x.shape
    h = self.GroupNorm_0(x).to(self.dtype)
    q = self.NIN_0(h).reshape(B, H * W, C).float()
    k = self.NIN_1(h).reshape(B, H * W, C).float()
    v = self.NIN_2(h).reshape(B, H * W, C).float()
    w = torch.bmm(q, k.transpose(1, 2)) * (int(C) ** -0.5)
    w = torch.softmax(w, dim=-1)
    h = torch.bmm(w, v).reshape(B, H, W, C).to(self.dtype)
    h = self.NIN_3(h)
    return skip_sum(x, h, self.skip_rescale)


class Upsample(nn.Module):
  """x2 upsample: nearest (then a f32 3x3 conv, ``with_conv``), or FIR
  (fused with a 3x3 transposed conv, ``Conv2d_0``, ``with_conv``)."""

  def __init__(self, in_ch: int, out_ch: Optional[int] = None,
               with_conv: bool = False, fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1),
               kernels: bool = True):
    super().__init__()
    out_ch = out_ch or in_ch
    self.fir, self.with_conv = fir, with_conv
    self.fir_kernel = tuple(fir_kernel)
    if with_conv and not fir:
      self.Conv3x3_0 = layers.Conv3x3(in_ch, out_ch, kernels=kernels)
    elif with_conv:
      self.Conv2d_0 = resample.Conv2d(in_ch, out_ch, 3, up=True,
                                      resample_kernel=fir_kernel,
                                      init=layers.default_init())

  def forward(self, x):
    if not self.fir:
      h = resample.naive_upsample_2d(x, 2)
      return self.Conv3x3_0(h) if self.with_conv else h
    if not self.with_conv:
      return resample.upsample_2d(x, self.fir_kernel, factor=2)
    return self.Conv2d_0(x)


class Downsample(nn.Module):
  """x2 downsample: (0, 1) padding then a f32 3x3 stride-2 VALID conv
  (``Conv_0``, ``with_conv``) or a 2x2 mean; or FIR (then a 3x3 stride-2
  conv, ``Conv2d_0``, ``with_conv``)."""

  def __init__(self, in_ch: int, out_ch: Optional[int] = None,
               with_conv: bool = False, fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1)):
    super().__init__()
    out_ch = out_ch or in_ch
    self.fir, self.with_conv = fir, with_conv
    self.fir_kernel = tuple(fir_kernel)
    if with_conv and not fir:
      self.Conv_0 = layers.Conv(in_ch, out_ch, 3)
    elif with_conv:
      self.Conv2d_0 = resample.Conv2d(in_ch, out_ch, 3, down=True,
                                      resample_kernel=fir_kernel,
                                      init=layers.default_init())

  def forward(self, x):
    if self.fir:
      if not self.with_conv:
        return resample.downsample_2d(x, self.fir_kernel, factor=2)
      return self.Conv2d_0(x)
    if not self.with_conv:
      return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    # flax nn.Conv without a dtype: the f32 parameters promote x.
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    x = F.pad(x, (0, 0, 0, 1, 0, 1))
    return conv_ops.conv_nhwc_plain(x, self.Conv_0.kernel, self.Conv_0.bias,
                                    stride=2)


class ResnetBlockDDPMpp(nn.Module):
  """The DDPM resblock of NCSN++: two ``act(GroupNorm)`` / 3x3 conv pairs
  (the kernel sites), the timestep projection between them, dropout, and
  a shortcut (``NIN_0``, or ``Conv3x3_2`` with ``conv_shortcut``) where the
  width changes."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, conv_shortcut: bool = False,
               dropout: float = 0.1, skip_rescale: bool = False,
               init_scale: float = 0., dtype: torch.dtype = torch.float32,
               kernels: bool = True):
    super().__init__()
    out_ch = out_ch or in_ch
    self.act, self.dropout, self.skip_rescale = act, dropout, skip_rescale
    self.GroupNorm_0 = norm_act(in_ch, act, dtype, kernels)
    self.Conv3x3_0 = layers.Conv3x3(in_ch, out_ch, dtype=dtype,
                                    kernels=kernels)
    if temb_dim is not None:
      self.Dense_0 = layers.Dense(temb_dim, out_ch, dtype=dtype)
    self.GroupNorm_1 = norm_act(out_ch, act, dtype, kernels)
    self.Conv3x3_1 = layers.Conv3x3(out_ch, out_ch, init_scale=init_scale,
                                    dtype=dtype, kernels=kernels)
    self.shortcut = None
    if in_ch != out_ch and conv_shortcut:
      self.shortcut = 'Conv3x3_2'
      self.Conv3x3_2 = layers.Conv3x3(in_ch, out_ch, dtype=dtype,
                                      kernels=kernels)
    elif in_ch != out_ch:
      self.shortcut = 'NIN_0'
      self.NIN_0 = layers.NIN(in_ch, out_ch, dtype=dtype)

  def forward(self, x, temb=None, train=True, generator=None):
    h = self.Conv3x3_0(self.GroupNorm_0(x))
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, None, None, :]
    h = self.GroupNorm_1(h)
    if train:
      h = layers.dropout(h, self.dropout, generator)
    h = self.Conv3x3_1(h)
    if self.shortcut is not None:
      x = getattr(self, self.shortcut)(x)
    return skip_sum(x, h, self.skip_rescale)


class ResnetBlockBigGANpp(nn.Module):
  """The BigGAN resblock of NCSN++: ``act(GroupNorm)``, resampling of both
  branches (``up`` or ``down``; FIR or nearest / mean), 3x3 conv, the
  timestep projection, ``act(GroupNorm)``, dropout, 3x3 conv, and a 1x1
  shortcut where the width or size changes."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, up: bool = False,
               down: bool = False, dropout: float = 0.1, fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1),
               skip_rescale: bool = True, init_scale: float = 0.,
               dtype: torch.dtype = torch.float32, kernels: bool = True):
    super().__init__()
    out_ch = out_ch or in_ch
    self.act, self.dropout, self.skip_rescale = act, dropout, skip_rescale
    self.up, self.down, self.fir = up, down, fir
    self.fir_kernel = tuple(fir_kernel)
    self.GroupNorm_0 = norm_act(in_ch, act, dtype, kernels)
    self.Conv3x3_0 = layers.Conv3x3(in_ch, out_ch, dtype=dtype,
                                    kernels=kernels)
    if temb_dim is not None:
      self.Dense_0 = layers.Dense(temb_dim, out_ch, dtype=dtype)
    self.GroupNorm_1 = norm_act(out_ch, act, dtype, kernels)
    self.Conv3x3_1 = layers.Conv3x3(out_ch, out_ch, init_scale=init_scale,
                                    dtype=dtype, kernels=kernels)
    self.shortcut = in_ch != out_ch or up or down
    if self.shortcut:
      self.Conv1x1_0 = layers.Conv1x1(in_ch, out_ch, dtype=dtype)

  def _resample(self, x):
    if self.up:
      return (resample.upsample_2d(x, self.fir_kernel, factor=2) if self.fir
              else resample.naive_upsample_2d(x, 2))
    if self.down:
      return (resample.downsample_2d(x, self.fir_kernel, factor=2)
              if self.fir else resample.naive_downsample_2d(x, 2))
    return x

  def forward(self, x, temb=None, train=True, generator=None):
    h = self._resample(self.GroupNorm_0(x))
    x = self._resample(x)
    h = self.Conv3x3_0(h)
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, None, None, :]
    h = self.GroupNorm_1(h)
    if train:
      h = layers.dropout(h, self.dropout, generator)
    h = self.Conv3x3_1(h)
    if self.shortcut:
      x = self.Conv1x1_0(x)
    return skip_sum(x, h, self.skip_rescale)
