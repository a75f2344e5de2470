"""Pyramidal optical-flow network and pressure U-Net, NHWC, with the flax
parameter names.

Counterpart of the JAX package's ``models/flownet.py``.  Module attributes
are the flax auto-names (``InferenceUnit_0`` is the coarsest level;
``DoubleRes_0`` of the PressureNet is its one shared flow-feature module),
so ``convert.params_from_jax`` copies a flax tree name for name.  Every
``Matching`` calls the cost volume ``ops.correlation`` (kernel K3 on the
card, its backward the K3 backward kernels) or, with ``kernels=False``,
its plain version; the convolutions are plain f32 ``F.conv2d``, as the JAX
package leaves them to XLA.  ``multiscale_data_mse`` and
``pressure_data_mse`` are the phase-1 PINN losses.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.models.layers import lecun_normal
from b_pinn_kalman_filter_tpu_torch.models.layers_ncsn import ResidualBlock
from b_pinn_kalman_filter_tpu_torch.ops.conv3x3 import conv_nhwc_plain
from b_pinn_kalman_filter_tpu_torch.ops.correlation import (
    correlation, correlation_plain)
from b_pinn_kalman_filter_tpu_torch.ops.grid_sample import (
    grid_sample_2d, make_normalized_grid)

Tensor = torch.Tensor


def _lrelu(x: Tensor) -> Tensor:
  return F.leaky_relu(x, 0.1)


def _nchw(x: Tensor) -> Tensor:
  return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
  return x.permute(0, 2, 3, 1).contiguous()


def _pool(x: Tensor, fn) -> Tensor:
  """2x2, stride-2 VALID pooling (flax ``avg_pool`` / ``max_pool``)."""
  return _nhwc(fn(_nchw(x), 2, 2))


def project(f: Tensor, u: Tensor, dt: float) -> Tensor:
  """Semi-Lagrangian backward warp of f (B, H, W, C) by u (B, H, W, 2).

  u[..., 0] displaces y and u[..., 1] displaces x, and the x displacement
  is scaled by (H - 1) / 2: the reference's channel swap, kept as it is.
  """
  B, H, W, C = f.shape
  grid = make_normalized_grid(B, H, W, dtype=f.dtype, device=f.device)
  disp = torch.cat([u[..., 1:2] / ((H - 1.0) / 2.0),
                    u[..., 0:1] / ((W - 1.0) / 2.0)], dim=-1)
  return grid_sample_2d(f, grid - disp * dt, padding_mode='border',
                        align_corners=True)


def resize_bilinear(x: Tensor, size: Sequence[int]) -> Tensor:
  """Bilinear resize with half-pixel centres (``jax.image.resize`` linear,
  no antialiasing; for upsampling both clamp at the border)."""
  return _nhwc(F.interpolate(_nchw(x), size=tuple(size), mode='bilinear',
                             align_corners=False))


class Conv(nn.Module):
  """flax ``nn.Conv``: ``kernel`` (kh, kw, in, out) lecun-normal, ``bias``
  zeros; ``size`` k or (kh, kw); symmetric ``padding`` p or (ph, pw)
  (default (kh // 2, kw // 2), 'SAME' at stride 1 for odd sizes)."""

  def __init__(self, in_ch: int, out_ch: int,
               size: Union[int, Tuple[int, int]] = 3, stride: int = 1,
               padding: Union[None, int, Tuple[int, int]] = None):
    super().__init__()
    kh, kw = (size, size) if isinstance(size, int) else size
    self.stride = stride
    self.padding = (kh // 2, kw // 2) if padding is None else padding
    layers._param(self, 'kernel', (kh, kw, in_ch, out_ch), lecun_normal)
    layers._param(self, 'bias', (out_ch,), layers.zeros_init)

  def forward(self, x):
    return conv_nhwc_plain(x, self.kernel, self.bias, stride=self.stride,
                           padding=self.padding)


class ConvFeature(nn.Module):
  """Stride-2 feature layer.  The strided conv pads (1, 1) on both sides,
  as torch ``Conv2d(k=3, s=2, p=1)`` does (XLA 'SAME' would pad (0, 1))."""

  def __init__(self, in_ch: int, out_ch: int):
    super().__init__()
    self.Conv_0 = Conv(in_ch, out_ch, stride=2, padding=1)
    self.Conv_1 = Conv(out_ch, out_ch)

  def forward(self, x):
    return _lrelu(self.Conv_1(_lrelu(self.Conv_0(x))))


class _ConvStack(nn.Module):
  """3x3 convs ``Conv_0 .. Conv_k`` with leaky ReLU between them."""

  def __init__(self, widths: Sequence[int]):
    super().__init__()
    self.n = len(widths) - 1
    for i in range(self.n):
      setattr(self, f'Conv_{i}', Conv(widths[i], widths[i + 1]))

  def forward(self, x):
    for i in range(self.n):
      x = getattr(self, f'Conv_{i}')(x)
      if i < self.n - 1:
        x = _lrelu(x)
    return x


class ConvField(_ConvStack):
  """Field head: C -> 128 -> 64 -> 32 -> out."""

  def __init__(self, in_ch: int, out_ch: int):
    super().__init__((in_ch, 128, 64, 32, out_ch))


class ConvUp(_ConvStack):
  """Final refiner: C -> 64 -> 32 -> out."""

  def __init__(self, in_ch: int, out_ch: int):
    super().__init__((in_ch, 64, 32, out_ch))


class FeatureExtractor(nn.Module):
  """Pyramid of stride-2 features, with the spatial and timestep embeddings
  added at each level."""

  def __init__(self, config):
    super().__init__()
    self.config = config
    widths = (config.data.num_channels,) + tuple(config.model.feature_nums)
    self.n = len(widths) - 1
    for i in range(self.n):
      setattr(self, f'ConvFeature_{i}', ConvFeature(widths[i], widths[i + 1]))

  def forward(self, f, x, y, t):
    model = self.config.model
    semb = layers.get_spatial_embedding(x, y, omega=model.spatial_embed_omega,
                                        s=model.spatial_embed_s_flow)
    result = []
    for i in range(self.n):
      temb = layers.get_timestep_embedding(t, f.shape[-1])[:, None, None, :]
      f = getattr(self, f'ConvFeature_{i}')(f + semb + temb)
      result.append(f)
      semb = _pool(semb, F.avg_pool2d)
    return result


class GroupedDeconv2x(nn.Module):
  """x2 upsampling, one 4x4 filter a channel, no bias: the JAX package's
  grouped convolution of the zero-dilated input (padding 2) with the
  UNflipped ``weight`` (4, 4, 1, C), written as a transposed convolution
  (stride 2, padding 1), which needs that kernel flipped."""

  def __init__(self, channels: int):
    super().__init__()
    self.channels = channels
    layers._param(self, 'weight', (4, 4, 1, channels), lecun_normal)

  def forward(self, x):
    w = torch.flip(self.weight, dims=(0, 1)).permute(3, 2, 0, 1)  # (C,1,4,4)
    return _nhwc(F.conv_transpose2d(_nchw(x), w, stride=2, padding=1,
                                    groups=self.channels))


class FlowUpsample(GroupedDeconv2x):
  """x2 upsampling of a flow field: :class:`GroupedDeconv2x` of its two
  channels."""

  def __init__(self):
    super().__init__(2)


class Matching(nn.Module):
  """Cost-volume matching: upsample the coarser flow and warp f2 by it,
  then the correlation (kernel K3, or its plain version without
  ``kernels``) and a field head."""

  def __init__(self, config, level: int, first: bool, kernels: bool = True):
    super().__init__()
    self.correlation = correlation if kernels else correlation_plain
    self.dt = config.data.dt * 0.5 ** level
    if not first:
      self.FlowUpsample_0 = FlowUpsample()
    self.ConvField_0 = ConvField(49, 2)

  def forward(self, feature1, feature2, flow=None):
    if flow is not None:
      flow = self.FlowUpsample_0(flow)
      feature2 = project(feature2, flow, -self.dt)
    else:
      flow = 0.0
    corr = F.leaky_relu(self.correlation(feature1, feature2, stride=1),
                        0.01)
    return flow + self.ConvField_0(corr)


class SubpixelRefinement(nn.Module):
  """Warp f2 by the matched flow and refine the flow from both features."""

  def __init__(self, config, level: int, channels: int):
    super().__init__()
    self.dt = config.data.dt * 0.5 ** (level + 1)
    self.ConvField_0 = ConvField(2 * channels + 2, 2)

  def forward(self, feature1, feature2, flow):
    feature2 = project(feature2, flow, -self.dt)
    block = torch.cat([feature1, feature2, flow], dim=-1)
    return flow + self.ConvField_0(block)


class InferenceUnit(nn.Module):
  """Matching then refinement at one pyramid level."""

  def __init__(self, config, level: int, first: bool, kernels: bool = True):
    super().__init__()
    channels = config.model.feature_nums[level]
    self.Matching_0 = Matching(config, level, first, kernels)
    self.SubpixelRefinement_0 = SubpixelRefinement(config, level, channels)

  def forward(self, feature1, feature2, flow=None):
    flow = self.Matching_0(feature1, feature2, flow)
    return self.SubpixelRefinement_0(feature1, feature2, flow)


class FinalUpsample(nn.Module):
  """Upsample the finest flow to full resolution and refine it from the
  two frames."""

  def __init__(self, num_channels: int):
    super().__init__()
    self.ConvUp_0 = ConvUp(2 * num_channels + 2, 2)

  def forward(self, f1, f2, x, size):
    x = resize_bilinear(x, size)
    return x + self.ConvUp_0(torch.cat([f1, f2, x], dim=-1))


class FlowNet(nn.Module):
  """Coarse-to-fine optical-flow cascade.  Returns the flows of every
  level, coarsest first, then the full-resolution flow.  ``kernels``
  selects the cost volume's kernel (the default) or its plain version."""

  def __init__(self, config, kernels: bool = True):
    super().__init__()
    self.config = config
    self.n_levels = len(config.model.feature_nums)
    self.FeatureExtractor_0 = FeatureExtractor(config)
    for i, level in enumerate(reversed(range(self.n_levels))):
      setattr(self, f'InferenceUnit_{i}',
              InferenceUnit(config, level, first=i == 0, kernels=kernels))
    self.FinalUpsample_0 = FinalUpsample(config.data.num_channels)

  def forward(self, f1, f2, x, y, t, size=None) -> List[Tensor]:
    n = 2 ** self.n_levels
    if f1.shape[1] % n or f1.shape[2] % n:
      raise ValueError(
          f'image size {f1.shape[1]}x{f1.shape[2]} must be divisible by '
          f'2^{self.n_levels} (= {n}) for {self.n_levels} pyramid levels')
    f1_features = self.FeatureExtractor_0(f1, x, y, t)
    f2_features = self.FeatureExtractor_0(f2, x, y, t)
    cascaded_flow = []
    flow = None
    for i, level in enumerate(reversed(range(self.n_levels))):
      flow = getattr(self, f'InferenceUnit_{i}')(
          f1_features[level], f2_features[level], flow)
      cascaded_flow.append(flow)
    if size is None:
      size = (self.config.data.image_size,) * 2
    cascaded_flow.append(self.FinalUpsample_0(f1, f2, flow, size))
    return cascaded_flow


def _mse(a: Tensor, b: Tensor) -> Tensor:
  return torch.mean((a - b) ** 2)


def multiscale_data_mse(veloc_pred: Sequence[Tensor], target: Tensor
                        ) -> Tensor:
  """Multi-scale flow loss: the flows of ``veloc_pred`` finest first,
  weighted 12.7, 5.5, 4.35, 3.9, 3.4, 1.1 and scaled by 1 / 2**i against
  the first two channels of ``target`` (B, H, W, >= 2), which is halved
  (every channel, bilinearly) after each term."""
  h, w = veloc_pred[-1].shape[1], veloc_pred[-1].shape[2]
  weights = [12.7, 5.5, 4.35, 3.9, 3.4, 1.1][:len(veloc_pred)]
  v_loss = 0.0
  for i, weight in enumerate(weights):
    scale = 1.0 / (2 ** i)
    v_loss = v_loss + weight * _mse(veloc_pred[-1 - i] * scale,
                                    target[..., :2] * scale)
    h, w = h // 2, w // 2
    target = resize_bilinear(target, (h, w))
  return v_loss


def pressure_data_mse(pressure: Tensor, target: Tensor) -> Tensor:
  """Pressure loss against channel 2 of ``target``."""
  return _mse(pressure, target[..., 2:3])


class DoubleRes(nn.Module):
  """Two NCSN residual blocks (InstanceNorm + ELU): in -> 2 in -> out."""

  def __init__(self, in_ch: int, out_ch: int):
    super().__init__()
    self.ResidualBlock_0 = ResidualBlock(in_ch, 2 * in_ch)
    self.ResidualBlock_1 = ResidualBlock(2 * in_ch, out_ch)

  def forward(self, x):
    return self.ResidualBlock_1(self.ResidualBlock_0(x))


class ConvTranspose(nn.Module):
  """flax ``nn.ConvTranspose((2, 2), strides=(2, 2))``: ``kernel``
  (2, 2, in, out) lecun-normal, ``bias``.  flax applies the kernel
  unflipped, so ``F.conv_transpose2d`` gets it flipped."""

  def __init__(self, in_ch: int, out_ch: int):
    super().__init__()
    layers._param(self, 'kernel', (2, 2, in_ch, out_ch), lecun_normal)
    layers._param(self, 'bias', (out_ch,), layers.zeros_init)

  def forward(self, x):
    w = torch.flip(self.kernel, dims=(0, 1)).permute(2, 3, 0, 1)
    return _nhwc(F.conv_transpose2d(_nchw(x), w, self.bias, stride=2))


class PressureNet(nn.Module):
  """U-Net over flow-norm features of the cascaded flows -> pressure."""

  FLOW_FEATURES = 32

  def __init__(self, config):
    super().__init__()
    self.config = config
    ch = list(config.model.feature_nums)
    L = len(ch)
    self.n_levels = L
    # DoubleRes_0: the one flow-feature module shared by every level.
    self.DoubleRes_0 = DoubleRes(3, self.FLOW_FEATURES)
    widths = [self.FLOW_FEATURES] + ch
    for i in range(L):                                   # down path
      setattr(self, f'DoubleRes_{1 + i}', DoubleRes(widths[i], widths[i + 1]))
    for idx in range(L - 1):                             # up path
      ch_o = ch[-2 - idx]
      setattr(self, f'ConvTranspose_{idx}', ConvTranspose(ch[-1 - idx], ch_o))
      setattr(self, f'DoubleRes_{L + 1 + idx}',
              DoubleRes(2 * ch_o + self.FLOW_FEATURES, ch_o))
    setattr(self, f'DoubleRes_{2 * L}', DoubleRes(ch[0], ch[0] // 2))
    self.Conv_0 = Conv(ch[0] // 2, ch[0] // 2, size=1)
    setattr(self, f'DoubleRes_{2 * L + 1}', DoubleRes(ch[0] // 2, 1))
    self.Conv_1 = Conv(1, 1, size=1)

  def _block(self, k: int) -> DoubleRes:
    return getattr(self, f'DoubleRes_{k}')

  def forward(self, cascaded_flow, x, y, t):
    model = self.config.model
    L = self.n_levels

    def norm_feature(flow):
      flow = flow.detach()
      flow_norm = -torch.sum(flow ** 2, dim=-1, keepdim=True)
      return self.DoubleRes_0(torch.cat([flow, flow_norm], dim=-1))

    semb = layers.get_spatial_embedding(x, y, omega=model.spatial_embed_omega,
                                        s=model.spatial_embed_s_pres)
    semb_list = [semb]
    for _ in range(L - 2):
      semb = _pool(semb, F.avg_pool2d)
      semb_list.append(semb)
    temb = layers.get_timestep_embedding(
        t, self.FLOW_FEATURES)[:, None, None, :]

    h = norm_feature(cascaded_flow[-1]) + temb + semb_list[0]
    h = self._block(1)(h)
    features = [h]
    for i in range(1, L):
      h = self._block(1 + i)(_pool(h, F.max_pool2d))
      features.append(h)
    features.pop(-1)

    for idx in range(len(features)):
      flow_feature = (norm_feature(cascaded_flow[idx + 2]) + temb
                      + semb_list[-1 - idx])
      h = getattr(self, f'ConvTranspose_{idx}')(h)
      block = torch.cat([features[-1 - idx], h, flow_feature], dim=-1)
      h = self._block(L + 1 + idx)(block)

    h = self.Conv_0(self._block(2 * L)(h))
    return self.Conv_1(self._block(2 * L + 1)(h))
