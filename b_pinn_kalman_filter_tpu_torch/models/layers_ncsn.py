"""NCSN building blocks, NHWC, with the flax parameter names.

Counterpart of the JAX package's ``models/layers_ncsn.py``; only what the
PressureNet's ``DoubleRes`` uses so far: ``NCSNConv`` and the
``resample=None`` branch of ``ResidualBlock`` (InstanceNorm + ELU).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.models.normalization import InstanceNorm2d
from b_pinn_kalman_filter_tpu_torch.ops.conv3x3 import conv_nhwc_plain


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


class NCSNConv(nn.Module):
  """k x k conv, stride 1, padding k // 2, with bias (``Conv_0`` as in
  flax).  (The JAX module's stride and dilation options are not used on
  the ported path and are not ported.)"""

  def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
    super().__init__()
    self.padding = kernel // 2
    self.Conv_0 = layers.Conv(in_ch, out_ch, kernel)
    self.Conv_0.param_inits['kernel'] = ncsn_conv_init()

  def forward(self, x):
    return conv_nhwc_plain(x, self.Conv_0.kernel, self.Conv_0.bias,
                           padding=self.padding)


class ResidualBlock(nn.Module):
  """NCSN residual block without resampling: norm, act, 3x3 conv, norm,
  act, 3x3 conv, plus the input (or its 1x1 conv when the width changes)."""

  def __init__(self, input_dim: int, output_dim: int,
               act: Callable = F.elu):
    super().__init__()
    self.act = act
    self.norm = InstanceNorm2d()
    self.NCSNConv_0 = NCSNConv(input_dim, output_dim)
    self.NCSNConv_1 = NCSNConv(output_dim, output_dim)
    if output_dim != input_dim:
      self.NCSNConv_2 = NCSNConv(input_dim, output_dim, kernel=1)

  def forward(self, x):
    h = self.NCSNConv_0(self.act(self.norm(x)))
    h = self.NCSNConv_1(self.act(self.norm(h)))
    shortcut = self.NCSNConv_2(x) if hasattr(self, 'NCSNConv_2') else x
    return shortcut + h
