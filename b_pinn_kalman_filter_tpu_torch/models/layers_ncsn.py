"""NCSN and NCSNv2 building blocks, NHWC, with the flax parameter names.

Counterpart of the JAX package's ``models/layers_ncsn.py``: ``NCSNConv``
(stride, dilation, bias, init scale), ``interpolate_bilinear``, the pooled
and upsampling convs, the RefineNet blocks (CRP, RCU, MSF, Refine and
their class-conditional versions) and the residual blocks.  Each block
registers its children under flax's auto-names, the class name and its
count in that block in order of creation (``NCSNConv_0``,
``InstanceNorm2dPlus_1``, ``RCUBlock_2``, ...), so the parameters carry
across by name.  A norm is given as a factory (``models/normalization.py``
``get_normalization``) called with the channel count, and for the
conditional blocks with ``bias=True`` as JAX calls it.

The convs are plain ``F.conv2d`` calls (cuDNN on the card), as they are
XLA's ``nn.Conv`` in JAX and no Pallas kernel; f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.models.normalization import InstanceNorm2d
from b_pinn_kalman_filter_tpu_torch.ops.conv3x3 import conv_nhwc_plain
from b_pinn_kalman_filter_tpu_torch.ops.grid_sample import grid_sample_2d


def ncsn_conv_init(init_scale: float = 1.0) -> layers.Init:
  """torch Conv2d's default (kaiming-uniform, i.e. variance_scaling(1/3,
  fan_in, uniform)) scaled by ``init_scale``; scale 0 is 1e-10."""
  init_scale = 1e-10 if init_scale == 0 else init_scale

  def init(shape, generator):
    fan_in = math.prod(shape[:-1])
    limit = math.sqrt(3.0 * (1.0 / 3.0) / fan_in)
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float64)
    return ((2.0 * u - 1.0) * limit * init_scale).float()

  return init


class FlaxNamed(nn.Module):
  """A module whose children take flax's auto-names through :meth:`add`:
  the class name and its count in this module, in order of creation."""

  def __init__(self):
    super().__init__()
    self._counts = {}

  def add(self, module: nn.Module) -> nn.Module:
    kind = type(module).__name__
    n = self._counts.get(kind, 0)
    self._counts[kind] = n + 1
    self.add_module(f'{kind}_{n}', module)
    return module


class NCSNConv(nn.Module):
  """k x k conv (``Conv_0`` as in flax) with padding ``dilation * (k //
  2)``, ``stride``, ``dilation``, and a bias unless ``bias`` is False;
  torch's default kernel init times ``init_scale``, zero bias."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
               stride: int = 1, bias: bool = True, dilation: int = 1,
               init_scale: float = 1.0):
    super().__init__()
    self.stride = stride
    self.dilation = dilation
    self.padding = dilation * (kernel // 2)
    self.Conv_0 = layers.Conv(in_ch, out_ch, kernel, bias=bias)
    self.Conv_0.param_inits['kernel'] = ncsn_conv_init(init_scale)

  def forward(self, x):
    return conv_nhwc_plain(x, self.Conv_0.kernel, self.Conv_0.bias,
                           stride=self.stride, padding=self.padding,
                           dilation=self.dilation)


def interpolate_bilinear(x: torch.Tensor, shape: Tuple[int, int]
                         ) -> torch.Tensor:
  """Bilinear resize to ``shape`` with align_corners=True (border), by the
  grid sampler, as the JAX function computes it."""
  B = x.shape[0]
  Ho, Wo = shape
  xs = torch.linspace(-1.0, 1.0, Wo, device=x.device)
  ys = torch.linspace(-1.0, 1.0, Ho, device=x.device)
  gy, gx = torch.meshgrid(ys, xs, indexing='ij')
  grid = torch.stack([gx, gy], dim=-1).expand(B, Ho, Wo, 2)
  return grid_sample_2d(x, grid, padding_mode='border', align_corners=True)


def _mean_pool(x):
  return (x[:, ::2, ::2] + x[:, 1::2, ::2]
          + x[:, ::2, 1::2] + x[:, 1::2, 1::2]) / 4.


def _nchw_pool(pool, x, *args, **kwargs):
  # A contiguous NCHW copy: on the card, ``F.avg_pool2d``'s backward of the
  # permuted (channels-last) view with padding gives wrong gradients
  # (torch 2.11, CUDA 12.8; tests/test_torch_kernels_cuda.py).
  x = x.permute(0, 3, 1, 2).contiguous()
  return pool(x, *args, **kwargs).permute(0, 2, 3, 1)


class ConvMeanPool(nn.Module):
  """Conv, then a 2x mean pool; ``adjust_padding`` pads the input's top
  row and left column first."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
               biases: bool = True, adjust_padding: bool = False):
    super().__init__()
    self.adjust_padding = adjust_padding
    self.NCSNConv_0 = NCSNConv(in_ch, out_ch, kernel=kernel, bias=biases)

  def forward(self, x):
    if self.adjust_padding:
      x = F.pad(x, (0, 0, 1, 0, 1, 0))
    return _mean_pool(self.NCSNConv_0(x))


class MeanPoolConv(nn.Module):
  """A 2x mean pool, then the conv."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
               biases: bool = True):
    super().__init__()
    self.NCSNConv_0 = NCSNConv(in_ch, out_ch, kernel=kernel, bias=biases)

  def forward(self, x):
    return self.NCSNConv_0(_mean_pool(x))


class UpsampleConv(nn.Module):
  """A 2x pixel-shuffle upsample of four copies of x (nearest), then the
  conv."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
               biases: bool = True):
    super().__init__()
    self.NCSNConv_0 = NCSNConv(in_ch, out_ch, kernel=kernel, bias=biases)

  def forward(self, x):
    B, H, W, C = x.shape
    out = x.repeat(1, 1, 1, 4).reshape(B, H, W, 2, 2, C)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C)
    return self.NCSNConv_0(out)


class CRPBlock(FlaxNamed):
  """Chained residual pooling: act, then ``n_stages`` times a 5x5 stride-1
  SAME max pool (avg pool, counting the padding, without ``maxpool``) and
  a conv, each stage's output added to the sum."""

  def __init__(self, features: int, n_stages: int,
               act: Callable = F.relu, maxpool: bool = True):
    super().__init__()
    self.act = act
    self.maxpool = maxpool
    self.convs = [self.add(NCSNConv(features, features, bias=False))
                  for _ in range(n_stages)]

  def forward(self, x):
    x = self.act(x)
    path = x
    for conv in self.convs:
      if self.maxpool:
        path = _nchw_pool(F.max_pool2d, path, 5, stride=1, padding=2)
      else:
        path = _nchw_pool(F.avg_pool2d, path, 5, stride=1, padding=2,
                          count_include_pad=True)
      path = conv(path)
      x = path + x
    return x


class CondCRPBlock(FlaxNamed):
  """Class-conditional CRP: each stage norm(path, y), a 5x5 avg pool and a
  conv."""

  def __init__(self, features: int, n_stages: int, normalizer,
               act: Callable = F.relu):
    super().__init__()
    self.act = act
    self.stages = [(self.add(normalizer(features, bias=True)),
                    self.add(NCSNConv(features, features, bias=False)))
                   for _ in range(n_stages)]

  def forward(self, x, y):
    x = self.act(x)
    path = x
    for norm, conv in self.stages:
      path = norm(path, y)
      path = _nchw_pool(F.avg_pool2d, path, 5, stride=1, padding=2,
                        count_include_pad=True)
      path = conv(path)
      x = path + x
    return x


class RCUBlock(FlaxNamed):
  """Residual conv unit: ``n_blocks`` times x plus ``n_stages`` of (act,
  conv)."""

  def __init__(self, features: int, n_blocks: int, n_stages: int,
               act: Callable = F.relu):
    super().__init__()
    self.act = act
    self.blocks = [[self.add(NCSNConv(features, features, bias=False))
                    for _ in range(n_stages)] for _ in range(n_blocks)]

  def forward(self, x):
    for convs in self.blocks:
      residual = x
      for conv in convs:
        x = conv(self.act(x))
      x = x + residual
    return x


class CondRCUBlock(FlaxNamed):
  """Class-conditional RCU: each stage norm(x, y), act, conv."""

  def __init__(self, features: int, n_blocks: int, n_stages: int,
               normalizer, act: Callable = F.relu):
    super().__init__()
    self.act = act
    self.blocks = [[(self.add(normalizer(features, bias=True)),
                     self.add(NCSNConv(features, features, bias=False)))
                    for _ in range(n_stages)] for _ in range(n_blocks)]

  def forward(self, x, y):
    for stages in self.blocks:
      residual = x
      for norm, conv in stages:
        x = conv(self.act(norm(x, y)))
      x = x + residual
    return x


class MSFBlock(FlaxNamed):
  """Multi-scale fusion: the sum over the inputs of conv(x_i) resized
  bilinearly to ``shape``."""

  def __init__(self, in_planes: Sequence[int], features: int):
    super().__init__()
    self.features = features
    self.convs = [self.add(NCSNConv(c, features, bias=True))
                  for c in in_planes]

  def forward(self, xs, shape):
    total = torch.zeros((xs[0].shape[0], shape[0], shape[1], self.features),
                        dtype=xs[0].dtype, device=xs[0].device)
    for conv, x in zip(self.convs, xs):
      total = total + interpolate_bilinear(conv(x), shape)
    return total


class CondMSFBlock(FlaxNamed):
  """Class-conditional MSF: conv(norm(x_i, y)) resized and summed."""

  def __init__(self, in_planes: Sequence[int], features: int, normalizer):
    super().__init__()
    self.features = features
    self.stages = [(self.add(normalizer(c, bias=True)),
                    self.add(NCSNConv(c, features, bias=True)))
                   for c in in_planes]

  def forward(self, xs, y, shape):
    total = torch.zeros((xs[0].shape[0], shape[0], shape[1], self.features),
                        dtype=xs[0].dtype, device=xs[0].device)
    for (norm, conv), x in zip(self.stages, xs):
      total = total + interpolate_bilinear(conv(norm(x, y)), shape)
    return total


class RefineBlock(FlaxNamed):
  """RefineNet block: an RCU on each input, their MSF (more than one
  input), a CRP, and an RCU of 3 blocks (``end``) or 1."""

  def __init__(self, in_planes: Sequence[int], features: int,
               act: Callable = F.relu, start: bool = False,
               end: bool = False, maxpool: bool = True):
    super().__init__()
    # A plain dict: each module is registered once, by add.
    self.parts = dict(
        rcus=[self.add(RCUBlock(c, 2, 2, act)) for c in in_planes],
        msf=(self.add(MSFBlock(in_planes, features))
             if len(in_planes) > 1 else None),
        crp=self.add(CRPBlock(features, 2, act, maxpool=maxpool)),
        out=self.add(RCUBlock(features, 3 if end else 1, 2, act)))

  def forward(self, xs, output_shape):
    p = self.parts
    assert len(xs) == len(p['rcus'])
    hs = [rcu(x) for rcu, x in zip(p['rcus'], xs)]
    h = hs[0] if p['msf'] is None else p['msf'](hs, output_shape)
    return p['out'](p['crp'](h))


class CondRefineBlock(FlaxNamed):
  """Class-conditional RefineNet block."""

  def __init__(self, in_planes: Sequence[int], features: int, normalizer,
               act: Callable = F.relu, start: bool = False,
               end: bool = False):
    super().__init__()
    self.parts = dict(
        rcus=[self.add(CondRCUBlock(c, 2, 2, normalizer, act))
              for c in in_planes],
        msf=(self.add(CondMSFBlock(in_planes, features, normalizer))
             if len(in_planes) > 1 else None),
        crp=self.add(CondCRPBlock(features, 2, normalizer, act)),
        out=self.add(CondRCUBlock(features, 3 if end else 1, 2, normalizer,
                                  act)))

  def forward(self, xs, y, output_shape):
    p = self.parts
    assert len(xs) == len(p['rcus'])
    hs = [rcu(x, y) for rcu, x in zip(p['rcus'], xs)]
    h = hs[0] if p['msf'] is None else p['msf'](hs, y, output_shape)
    return p['out'](p['crp'](h, y), y)


class ResidualBlock(FlaxNamed):
  """NCSN residual block: norm, act, conv, norm, act, conv, plus a
  shortcut.  ``resample`` 'down': the second conv a ``ConvMeanPool`` and
  the shortcut a 1x1 one (with ``dilation`` > 1 dilated 3x3 convs
  instead, without downsampling); None: the shortcut x itself, or its
  conv (dilated 3x3, else 1x1) where the width changes.  The PressureNet
  builds it with the defaults (InstanceNorm, ELU)."""

  def __init__(self, input_dim: int, output_dim: int,
               normalization=InstanceNorm2d, resample: Optional[str] = None,
               act: Callable = F.elu, adjust_padding: bool = False,
               dilation: int = 1):
    super().__init__()
    self.act = act
    norm, add = normalization, self.add
    # The parts in the order forward uses them (a plain dict: each module
    # is registered once, under its flax name, by add).
    p = self.parts = {'norm_0': add(norm(input_dim))}
    if resample == 'down':
      if dilation > 1:
        p['conv_0'] = add(NCSNConv(input_dim, input_dim, dilation=dilation))
        p['norm_1'] = add(norm(input_dim))
        p['conv_1'] = add(NCSNConv(input_dim, output_dim,
                                   dilation=dilation))
        p['shortcut'] = add(NCSNConv(input_dim, output_dim,
                                     dilation=dilation))
      else:
        p['conv_0'] = add(NCSNConv(input_dim, input_dim))
        p['norm_1'] = add(norm(input_dim))
        p['conv_1'] = add(ConvMeanPool(input_dim, output_dim, 3,
                                       adjust_padding=adjust_padding))
        p['shortcut'] = add(ConvMeanPool(input_dim, output_dim, 1,
                                         adjust_padding=adjust_padding))
    elif resample is None:
      p['conv_0'] = add(NCSNConv(input_dim, output_dim, dilation=dilation))
      p['norm_1'] = add(norm(output_dim))
      p['conv_1'] = add(NCSNConv(output_dim, output_dim, dilation=dilation))
      if output_dim == input_dim:
        p['shortcut'] = None
      elif dilation > 1:
        p['shortcut'] = add(NCSNConv(input_dim, output_dim,
                                     dilation=dilation))
      else:
        p['shortcut'] = self._conv1x1(input_dim, output_dim)
    else:
      raise Exception('invalid resample value')

  def _conv1x1(self, input_dim, output_dim):
    return self.add(NCSNConv(input_dim, output_dim, kernel=1))

  def forward(self, x, y=None):
    p = self.parts

    def norm(name, h):
      return p[name](h) if y is None else p[name](h, y)

    h = p['conv_0'](self.act(norm('norm_0', x)))
    h = p['conv_1'](self.act(norm('norm_1', h)))
    shortcut = x if p['shortcut'] is None else p['shortcut'](x)
    return shortcut + h


class _Conv1x1(nn.Module):
  """flax ``nn.Conv(out, (1, 1))`` as a child of its block: ``kernel``
  lecun-normal, zero ``bias``."""

  def __init__(self, in_ch: int, out_ch: int):
    super().__init__()
    layers._param(self, 'kernel', (1, 1, in_ch, out_ch), layers.lecun_normal)
    layers._param(self, 'bias', (out_ch,), layers.zeros_init)

  def forward(self, x):
    return conv_nhwc_plain(x, self.kernel, self.bias)


class ConditionalResidualBlock(ResidualBlock):
  """Class-conditional NCSN residual block: ``forward(x, y)``, its norms
  conditional; where the width changes without dilation the shortcut is
  flax's plain 1x1 ``Conv_0`` (lecun-normal)."""

  def _conv1x1(self, input_dim, output_dim):
    conv = _Conv1x1(input_dim, output_dim)
    self.add_module('Conv_0', conv)
    return conv

  def forward(self, x, y):
    return super().forward(x, y)
