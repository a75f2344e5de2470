"""Layers of the DDPM score network in PyTorch (and the spatial embedding
of the flow nets).

Counterpart of the JAX package's ``models/layers.py``.  Layout is NHWC and
every parameter keeps its flax name and layout (conv ``kernel`` HWIO,
``Dense``/``NIN`` weights (in, out), GroupNorm ``scale``/``bias``), so a
module's ``named_parameters()`` are the flax param paths joined by dots and
``convert.params_from_jax`` is a name-for-name copy.

Each module computes in ``dtype`` (bf16 on the card) from float32
parameters, casting at use as flax does.  ``kernels=True`` sends the two
kernel sites to the ops wrappers — ``Conv3x3`` where the JAX dispatch guard
``winograd_applicable`` holds, and the GroupNorm+SiLU/ELU of the resblocks
— and ``kernels=False`` sends them to the ops' plain versions, so a run can
hold the kernel path against the plain path on the same device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as conv_ops
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as gn_ops

Tensor = torch.Tensor
Init = Callable[[Sequence[int], torch.Generator], Tensor]


def get_act(config) -> Callable[[Tensor], Tensor]:
  """Activation from config."""
  name = config.model.nonlinearity.lower()
  if name == 'elu':
    return F.elu
  elif name == 'relu':
    return F.relu
  elif name == 'lrelu':
    return _leaky_relu
  elif name == 'swish':
    return F.silu
  else:
    raise NotImplementedError('activation function does not exist!')


def _leaky_relu(x: Tensor) -> Tensor:
  return F.leaky_relu(x, negative_slope=0.2)


# Activations the GroupNorm kernel fuses, by the name the kernel takes.
FUSABLE_ACTS = {F.silu: 'silu', F.elu: 'elu'}


# ---------------------------------------------------------------------------
# Initialisation: each module records an init function per parameter, and
# init_params fills them in registration order from one generator.
# ---------------------------------------------------------------------------

def default_init(scale: float = 1.0) -> Init:
  """DDPM initialization: variance_scaling(scale, fan_avg, uniform), with
  fans taken as flax does for (..., in, out) kernels; scale 0 is 1e-10."""
  scale = 1e-10 if scale == 0 else scale

  def init(shape, generator):
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float64)
    return ((2.0 * u - 1.0) * limit).float()

  return init


def zeros_init(shape, generator):
  return torch.zeros(tuple(shape))


def ones_init(shape, generator):
  return torch.ones(tuple(shape))


def _param(module: nn.Module, name: str, shape: Sequence[int],
           init: Init) -> None:
  module.register_parameter(name, nn.Parameter(torch.empty(tuple(shape))))
  if 'param_inits' not in module.__dict__:
    module.param_inits = {}
  module.param_inits[name] = init


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
  """Fill every parameter from its init function (``generator`` on CPU)."""
  for m in model.modules():
    for name, init in m.__dict__.get('param_inits', {}).items():
      p = getattr(m, name)
      p.copy_(init(p.shape, generator).to(p.device))


# ---------------------------------------------------------------------------
# Basic layers (flax nn.Dense / nn.Conv / nn.GroupNorm counterparts)
# ---------------------------------------------------------------------------

class Dense(nn.Module):
  """flax ``nn.Dense``: ``kernel`` (in, out), ``bias`` (out,)."""

  def __init__(self, in_features: int, out_features: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    _param(self, 'kernel', (in_features, out_features), default_init())
    _param(self, 'bias', (out_features,), zeros_init)

  def forward(self, x):
    return F.linear(x.to(self.dtype), self.kernel.to(self.dtype).t(),
                    self.bias.to(self.dtype))


class Conv(nn.Module):
  """flax ``nn.Conv`` parameters: ``kernel`` (kh, kw, in, out), ``bias``."""

  def __init__(self, in_ch: int, out_ch: int, size: int,
               init_scale: float = 1.0):
    super().__init__()
    _param(self, 'kernel', (size, size, in_ch, out_ch),
           default_init(init_scale))
    _param(self, 'bias', (out_ch,), zeros_init)


class GroupNorm(nn.Module):
  """flax ``nn.GroupNorm(epsilon=1e-6)`` followed by ``act``.

  With ``act`` silu or elu and ``kernels=True`` this is a kernel site
  (JAX ``norm_act`` with ``fused_gn``): one call of the fused kernel K2.
  Otherwise the plain GroupNorm, then ``act`` if any.  ``dtype=None`` keeps
  the input's dtype.
  """

  def __init__(self, channels: int, num_groups: int,
               dtype: Optional[torch.dtype] = None,
               act: Optional[Callable] = None, kernels: bool = True):
    super().__init__()
    self.num_groups = num_groups
    self.dtype = dtype
    self.act = act
    self.kernels = kernels
    _param(self, 'scale', (channels,), ones_init)
    _param(self, 'bias', (channels,), zeros_init)

  def forward(self, x):
    if self.dtype is not None:
      x = x.to(self.dtype)
    act_name = FUSABLE_ACTS.get(self.act)
    if act_name is None:
      y = gn_ops.groupnorm_act_plain(x, self.scale, self.bias,
                                     self.num_groups, 'none', 1e-6)
      return y if self.act is None else self.act(y)
    fn = gn_ops.groupnorm_act if self.kernels else gn_ops.groupnorm_act_plain
    return fn(x, self.scale, self.bias, self.num_groups, act_name, 1e-6)


def norm_act(channels: int, act: Callable, dtype: torch.dtype,
             kernels: bool = True) -> GroupNorm:
  """``act(GroupNorm(x))`` with ``min(32, C)`` groups (JAX ``norm_act``)."""
  return GroupNorm(channels, min(32, channels), dtype=dtype, act=act,
                   kernels=kernels)


class Conv3x3(nn.Module):
  """3x3 SAME stride-1 conv with DDPM init (``Conv_0`` as in flax).

  A kernel site: with ``kernels=True`` and the JAX guard satisfied it calls
  kernel K1, else the plain conv of the same semantics.  (The JAX module's
  ``stride``, ``dilation`` and ``bias`` are 1, 1 and True wherever the DDPM
  uses it, and are not ported.)
  """

  def __init__(self, in_ch: int, out_ch: int, init_scale: float = 1.0,
               dtype: torch.dtype = torch.float32, kernels: bool = True):
    super().__init__()
    self.dtype = dtype
    self.kernels = kernels
    self.Conv_0 = Conv(in_ch, out_ch, 3, init_scale=init_scale)

  def forward(self, x):
    x = x.to(self.dtype)
    kernel, bias = self.Conv_0.kernel, self.Conv_0.bias
    if self.kernels and conv_ops.applicable(x.shape, kernel.shape):
      return conv_ops.conv3x3(x, kernel, bias)
    return conv_ops.conv3x3_plain(x, kernel, bias)


class Conv1x1(nn.Module):
  """1x1 conv with DDPM init (``Conv_0`` as in flax; stride 1, with bias)."""

  def __init__(self, in_ch: int, out_ch: int, init_scale: float = 1.0,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.Conv_0 = Conv(in_ch, out_ch, 1, init_scale=init_scale)

  def forward(self, x):
    return conv_ops.conv_nhwc_plain(x.to(self.dtype), self.Conv_0.kernel,
                                    self.Conv_0.bias)


def get_timestep_embedding(timesteps: Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> Tensor:
  """Transformer sinusoidal timestep embedding, f32."""
  assert timesteps.ndim == 1
  half_dim = embedding_dim // 2
  emb = math.log(max_positions) / (half_dim - 1 if half_dim > 1 else 1)
  emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                               device=timesteps.device) * -emb)
  emb = timesteps.float()[:, None] * emb[None, :]
  emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
  if embedding_dim % 2 == 1:
    emb = F.pad(emb, (0, 1))
  assert emb.shape == (timesteps.shape[0], embedding_dim)
  return emb


def get_spatial_embedding(x: Tensor, y: Tensor, omega: float,
                          s: float = 1.0) -> Tensor:
  """Radial sinusoid field of the coordinate images x, y (B, H, W, 1).

  The maxima are over the whole tensor, batch included, as in the JAX
  package; the sqrt is guarded by 1e-12 where its gradient is singular.
  """
  eps = 1e-12
  e1 = torch.sin(omega * torch.sqrt(x ** 2 + y ** 2 + eps))
  e2 = torch.sin(omega * torch.sqrt((x.max() - x) ** 2
                                    + (y.max() - y) ** 2 + eps))
  return (e1 + e2) / s


class NIN(nn.Module):
  """Network-in-network: per-pixel dense over channels, ``W`` (in, out)."""

  def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    _param(self, 'W', (in_dim, num_units), default_init(init_scale))
    _param(self, 'b', (num_units,), zeros_init)

  def forward(self, x):
    return (torch.tensordot(x.to(self.dtype), self.W.to(self.dtype), dims=1)
            + self.b.to(self.dtype))


class AttnBlock(nn.Module):
  """Spatial self-attention as (B, HW, C) batched matmuls, f32 scores."""

  def __init__(self, channels: int, num_groups: int = 32,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.GroupNorm_0 = GroupNorm(channels, min(num_groups, channels),
                                 dtype=dtype)
    self.NIN_0 = NIN(channels, channels, dtype=dtype)
    self.NIN_1 = NIN(channels, channels, dtype=dtype)
    self.NIN_2 = NIN(channels, channels, dtype=dtype)
    self.NIN_3 = NIN(channels, channels, init_scale=0., dtype=dtype)

  def forward(self, x):
    B, H, W, C = x.shape
    h = self.GroupNorm_0(x)
    q = self.NIN_0(h).reshape(B, H * W, C).float()
    k = self.NIN_1(h).reshape(B, H * W, C).float()
    v = self.NIN_2(h).reshape(B, H * W, C).float()
    w = torch.bmm(q, k.transpose(1, 2)) * (int(C) ** -0.5)
    w = torch.softmax(w, dim=-1)
    h = torch.bmm(w, v).reshape(B, H, W, C).to(self.dtype)
    h = self.NIN_3(h)
    return x + h


def naive_upsample_2d(x: Tensor, factor: int = 2) -> Tensor:
  """Nearest-neighbor upsample in NHWC."""
  return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


class Upsample(nn.Module):
  """Nearest x2 upsample, optional 3x3 conv (a kernel site)."""

  def __init__(self, channels: int, with_conv: bool = False,
               dtype: torch.dtype = torch.float32, kernels: bool = True):
    super().__init__()
    self.with_conv = with_conv
    if with_conv:
      self.Conv3x3_0 = Conv3x3(channels, channels, dtype=dtype,
                               kernels=kernels)

  def forward(self, x):
    h = naive_upsample_2d(x, 2)
    if self.with_conv:
      h = self.Conv3x3_0(h)
    return h


class Downsample(nn.Module):
  """x2 downsample: (0,1) pad then stride-2 VALID conv, or avg-pool."""

  def __init__(self, channels: int, with_conv: bool = False,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.with_conv = with_conv
    self.dtype = dtype
    if with_conv:
      self.Conv_0 = Conv(channels, channels, 3)

  def forward(self, x):
    B, H, W, C = x.shape
    if self.with_conv:
      x = F.pad(x.to(self.dtype), (0, 0, 0, 1, 0, 1))
      x = conv_ops.conv_nhwc_plain(x, self.Conv_0.kernel, self.Conv_0.bias,
                                   stride=2)
    else:
      x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    assert x.shape == (B, H // 2, W // 2, C)
    return x


class ResnetBlockDDPM(nn.Module):
  """DDPM ResNet block: two GroupNorm+act / 3x3 conv pairs, both kernel
  sites, the timestep projection between them, and a NIN shortcut when the
  width changes.  (The JAX block's ``conv_shortcut`` option is never set by
  the DDPM and is not ported.)"""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, dropout: float = 0.1,
               dtype: torch.dtype = torch.float32, kernels: bool = True):
    super().__init__()
    out_ch = in_ch if out_ch is None else out_ch
    self.act = act
    self.dropout = dropout
    self.GroupNorm_0 = norm_act(in_ch, act, dtype, kernels)
    self.Conv3x3_0 = Conv3x3(in_ch, out_ch, dtype=dtype, kernels=kernels)
    if temb_dim is not None:
      self.Dense_0 = Dense(temb_dim, out_ch, dtype=dtype)
    self.GroupNorm_1 = norm_act(out_ch, act, dtype, kernels)
    self.Conv3x3_1 = Conv3x3(out_ch, out_ch, init_scale=0., dtype=dtype,
                             kernels=kernels)
    if in_ch != out_ch:
      self.NIN_0 = NIN(in_ch, out_ch, dtype=dtype)

  def forward(self, x, temb=None, train=True):
    h = self.GroupNorm_0(x)
    h = self.Conv3x3_0(h)
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, None, None, :]
    h = self.GroupNorm_1(h)
    h = F.dropout(h, self.dropout, training=train)
    h = self.Conv3x3_1(h)
    if hasattr(self, 'NIN_0'):
      x = self.NIN_0(x)
    return x + h
