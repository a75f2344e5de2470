"""LiteFlowNet, NHWC, with the flax parameter names.

Counterpart of the JAX package's ``models/liteflownet.py``, quirks
included:

* :func:`backward_warp` displaces both grid coordinates by the flow's
  first channel alone (``flow[..., 0:1]``), on a grid of the flow's size
  scaled by the input's height: the JAX package keeps the reference's
  empty-slice bug, and so does the port.
* The input mean shifts are the hardcoded constants of the reference.
* Each frame has its own feature pyramid (``Features_0``, ``Features_1``),
  as in the JAX package; the published network shares one.

Module attributes are the flax auto-names, numbered per module type in
the order the flax module creates them (``Matching_0`` is level 6, the
coarsest; ``Conv_0`` of a level-2 ``Matching`` is its first 1x1 conv), so
``convert.params_from_jax`` copies a flax tree name for name.  The
cost volume is ``ops.correlation``: at stride 1 (levels 6, 5 and 4)
kernel K3 on the card, its gradients the K3 backward kernels B1 and B2;
at stride 2 (levels 3 and 2) its plain version, as the JAX dispatch
sends stride 2 to XLA.  With ``kernels=False`` every level takes the
plain version.  The convolutions are plain f32 ``F.conv2d``, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.models.flownet import (Conv,
                                                           GroupedDeconv2x,
                                                           resize_bilinear)
from b_pinn_kalman_filter_tpu_torch.ops.correlation import (
    correlation, correlation_plain)
from b_pinn_kalman_filter_tpu_torch.ops.grid_sample import (
    grid_sample_2d, make_normalized_grid)

Tensor = torch.Tensor

_KSIZE = [0, 0, 7, 5, 5, 3, 3]
# The pyramid's channels at each level (Matching and Subpixel take level
# 2's 32 to 64 by 1x1 convs first).
_FEAT_CH = [0, 32, 32, 64, 96, 128, 192]
MEAN_SHIFTS = (0.411618, 0.410782)


def _lrelu(x: Tensor) -> Tensor:
  return F.leaky_relu(x, 0.1)


def backward_warp(tensor_input: Tensor, flow: Tensor) -> Tensor:
  """Warp ``tensor_input`` (B, H, W, C) by ``flow`` (B, h, w, 2): bilinear
  samples, zeros outside, at the identity grid of the flow's size plus
  ``flow[..., 0] / ((H - 1) / 2)`` on BOTH coordinates (the reference's
  channel bug, kept)."""
  B, H = tensor_input.shape[0], tensor_input.shape[1]
  grid = make_normalized_grid(B, flow.shape[1], flow.shape[2],
                              dtype=tensor_input.dtype,
                              device=tensor_input.device)
  disp = flow[..., 0:1] / ((H - 1.0) / 2.0)
  return grid_sample_2d(tensor_input, grid + disp, padding_mode='zeros',
                        align_corners=True)


def _conv(in_ch: int, out_ch: int, k=3, stride: int = 1) -> Conv:
  """The JAX ``_conv``: k or (kh, kw), padded (k - 1) // 2 on each side
  of each axis (so a stride-2 3x3 pads (1, 1), as torch does)."""
  kh, kw = (k, k) if isinstance(k, int) else k
  return Conv(in_ch, out_ch, (kh, kw), stride,
              padding=((kh - 1) // 2, (kw - 1) // 2))


class _Flax(nn.Module):
  """A module whose children are named as flax's ``nn.compact`` names
  them: ``<Type>_<n>``, n counting that type's children in the order of
  their creation.  ``_add`` registers a child under that name alone and
  returns the name; ``_get`` returns the children of a list of names."""

  def __init__(self):
    super().__init__()
    self._counts = {}

  def _add(self, kind: str, module: nn.Module) -> str:
    n = self._counts.get(kind, 0)
    self._counts[kind] = n + 1
    setattr(self, f'{kind}_{n}', module)
    return f'{kind}_{n}'

  def _get(self, names: Sequence[str]) -> List[nn.Module]:
    return [getattr(self, name) for name in names]


class Features(_Flax):
  """The six-level feature pyramid: 32 channels at full size (7x7), 32 at
  1/2, 64 at 1/4, 96 at 1/8, 128 at 1/16 and 192 at 1/32."""

  # (out channels, kernel, stride, an output follows) of each conv.
  LAYERS = ((32, 7, 1, True), (32, 3, 2, False), (32, 3, 1, False),
            (32, 3, 1, True), (64, 3, 2, False), (64, 3, 1, True),
            (96, 3, 2, False), (96, 3, 1, True), (128, 3, 2, True),
            (192, 3, 2, True))

  def __init__(self, in_ch: int):
    super().__init__()
    self.convs = []
    for out_ch, k, stride, _ in self.LAYERS:
      self.convs.append(self._add('Conv', _conv(in_ch, out_ch, k, stride)))
      in_ch = out_ch

  def forward(self, x: Tensor) -> List[Tensor]:
    out = []
    for conv, (_, _, _, keep) in zip(self._get(self.convs), self.LAYERS):
      x = _lrelu(conv(x))
      if keep:
        out.append(x)
    return out


def _head(owner: _Flax, in_ch: int, level: int) -> List[str]:
  """The field head of Matching and Subpixel, added to ``owner``: 3x3
  convs to 128, 64 and 32, then a k x k conv to the 2 flow channels."""
  widths = (in_ch, 128, 64, 32)
  names = [owner._add('Conv', _conv(a, b)) for a, b in zip(widths, widths[1:])]
  return names + [owner._add('Conv', _conv(32, 2, _KSIZE[level]))]


def _apply_head(convs: Sequence[Conv], x: Tensor) -> Tensor:
  """The head's convs, leaky ReLU after all but the last."""
  for conv in convs[:-1]:
    x = _lrelu(conv(x))
  return convs[-1](x)


class _Level(_Flax):
  """What Matching and Subpixel share: the level, its warp scale
  ``data.dt * 0.5 ** level`` and, at level 2, the 1x1 convs that take
  both frames' 32 features to 64."""

  def __init__(self, config, level: int):
    super().__init__()
    self.level = level
    self.scale = config.data.dt * 0.5 ** level
    if level == 2:
      self.squeeze = [self._add('Conv', _conv(32, 64, 1)) for _ in range(2)]

  def _features(self, feat1: Tensor, feat2: Tensor):
    if self.level == 2:
      squeeze1, squeeze2 = self._get(self.squeeze)
      feat1 = _lrelu(squeeze1(feat1))
      feat2 = _lrelu(squeeze2(feat2))
    return feat1, feat2

  @property
  def channels(self) -> int:
    """The feature channels after :meth:`_features`."""
    return 64 if self.level == 2 else _FEAT_CH[self.level]


class Matching(_Level):
  """Cost-volume matching: upsample the coarser flow and warp the second
  frame's features by it, then the cost volume (stride 1 at levels 6 to
  4; stride 2 and a x2 upsampling at 3 and 2) and the field head."""

  def __init__(self, config, level: int, first: bool, kernels: bool = True):
    super().__init__(config, level)
    self.correlation = correlation if kernels else correlation_plain
    self.upsample = None if first else self._add('GroupedDeconv2x',
                                                  GroupedDeconv2x(2))
    self.corr_upsample = (None if level >= 4 else
                          self._add('GroupedDeconv2x', GroupedDeconv2x(49)))
    self.head = _head(self, 49, level)

  def forward(self, first, second, feat1, feat2, flow=None):
    feat1, feat2 = self._features(feat1, feat2)
    if flow is not None:
      flow = getattr(self, self.upsample)(flow)
      feat2 = backward_warp(feat2, flow * self.scale)
    if self.level >= 4:
      corr = _lrelu(self.correlation(feat1, feat2, stride=1))
    else:
      corr = _lrelu(self.correlation(feat1, feat2, stride=2))
      corr = getattr(self, self.corr_upsample)(corr)
    h = _apply_head(self._get(self.head), corr)
    return h if flow is None else flow + h


class Subpixel(_Level):
  """Subpixel refinement: warp the second frame's features by the flow
  and refine the flow from both features and itself."""

  def __init__(self, config, level: int):
    super().__init__(config, level)
    self.head = _head(self, 2 * self.channels + 2, level)

  def forward(self, first, second, feat1, feat2, flow):
    feat1, feat2 = self._features(feat1, feat2)
    feat2 = backward_warp(feat2, flow * self.scale)
    block = torch.cat([feat1, feat2, flow], dim=-1)
    return flow + _apply_head(self._get(self.head), block)


def _unfold(x: Tensor, k: int) -> Tensor:
  """The k x k neighbourhoods of a 1-channel map (B, H, W, 1), zero
  padded, as (B, H, W, k * k) in row-major kernel order (``F.unfold``'s)."""
  H, W = x.shape[1], x.shape[2]
  pad = (k - 1) // 2
  xp = F.pad(x, (0, 0, pad, pad, pad, pad))
  return torch.stack([xp[:, i:i + H, j:j + W, 0]
                      for i in range(k) for j in range(k)], dim=-1)


class Regularization(_Flax):
  """Feature-driven local filtering of the flow: a softmax over the k x k
  neighbourhood (k = 3 at levels 6 and 5, 5 at 4 and 3, 7 at 2), its
  logits -dist**2 from the brightness error of the warp (detached), the
  mean-free flow and the first frame's features; the distance conv is k x
  k at levels 6 and 5 and separable ((k, 1) then (1, k)) below."""

  def __init__(self, config, level: int):
    super().__init__()
    self.level = level
    self.scale = config.data.dt * 0.5 ** level
    self.k = k = _KSIZE[level]
    dist_ch = k * k
    feat_ch = _FEAT_CH[level]
    self.featf = (None if level >= 5 else
                  self._add('Conv', _conv(feat_ch, 128, 1)))
    widths = (1 + 2 + (feat_ch if level >= 5 else 128), 128, 128, 64, 64,
              32, 32)
    self.body = [self._add('Conv', _conv(a, b))
                 for a, b in zip(widths, widths[1:])]
    if level >= 5:
      self.dist = [self._add('Conv', _conv(32, dist_ch, k))]
    else:
      self.dist = [self._add('Conv', _conv(32, dist_ch, (k, 1))),
                   self._add('Conv', _conv(dist_ch, dist_ch, (1, k)))]
    self.scales = [self._add('Conv', Conv(dist_ch, 1, 1)) for _ in range(2)]

  def forward(self, first, second, feat1, feat2, flow):
    diff = first - backward_warp(second, flow * self.scale)
    diff = torch.sqrt(torch.sum(diff ** 2, dim=-1, keepdim=True)
                      + 1e-12).detach()
    featf = (feat1 if self.featf is None else
             _lrelu(getattr(self, self.featf)(feat1)))
    flow_mean = torch.mean(flow, dim=(1, 2), keepdim=True)
    h = torch.cat([diff, flow - flow_mean, featf], dim=-1)
    for conv in self._get(self.body):
      h = _lrelu(conv(h))
    for conv in self._get(self.dist):
      h = conv(h)
    dist = -(h ** 2)
    dist = torch.exp(dist - torch.amax(dist, dim=-1, keepdim=True))
    divisor = 1.0 / torch.sum(dist, dim=-1, keepdim=True)
    ux = _unfold(flow[..., 0:1], self.k)
    uy = _unfold(flow[..., 1:2], self.k)
    scale_x, scale_y = self._get(self.scales)
    return torch.cat([scale_x(dist * ux) * divisor,
                      scale_y(dist * uy) * divisor], dim=-1)


class LiteFlowNet(_Flax):
  """The LiteFlowNet cascade: f1, f2 (B, H, W, C) -> the flows of levels
  6 down to 2 (1/32 to 1/2 of the input's size), then the full-size flow
  (the level-2 flow resized bilinearly to ``size``, default the input's,
  times 2).  x, y and t are taken for the PINN's signature and not read.
  ``kernels`` selects the cost volume's kernel (the default) or its plain
  version at every level."""

  LEVELS = (6, 5, 4, 3, 2)

  def __init__(self, config, kernels: bool = True):
    super().__init__()
    self.config = config
    channels = config.data.num_channels
    self._add('Features', Features(channels))
    self._add('Features', Features(channels))
    self.units = []
    for i, level in enumerate(self.LEVELS):
      self.units.append((
          self._add('Matching', Matching(config, level, first=i == 0,
                                         kernels=kernels)),
          self._add('Subpixel', Subpixel(config, level)),
          self._add('Regularization', Regularization(config, level))))

  def forward(self, f1, f2, x=None, y=None, t=None, size=None
              ) -> List[Tensor]:
    n = 2 ** 5
    if f1.shape[1] % n or f1.shape[2] % n:
      raise ValueError(f'image size {f1.shape[1]}x{f1.shape[2]} must be '
                       f'divisible by {n} for the six-level pyramid')
    f1 = f1 - MEAN_SHIFTS[0]
    f2 = f2 - MEAN_SHIFTS[1]
    feats1 = self.Features_0(f1)
    feats2 = self.Features_1(f2)
    firsts, seconds = [f1], [f2]
    for lvl in range(1, 6):
      firsts.append(resize_bilinear(firsts[-1], feats1[lvl].shape[1:3]))
      seconds.append(resize_bilinear(seconds[-1], feats2[lvl].shape[1:3]))
    flow = None
    collection = []
    for idx, unit in zip((-1, -2, -3, -4, -5), self.units):
      args = (firsts[idx], seconds[idx], feats1[idx], feats2[idx])
      for module in self._get(unit):
        flow = module(*args, flow)
      collection.append(flow)
    full = (f1.shape[1], f1.shape[2]) if size is None else size
    collection.append(resize_bilinear(collection[-1], full) * 2)
    return collection


def postprocess_flow(flow_collection: Sequence[Tensor], raw_shape,
                     processed_shape) -> Tensor:
  """The last flow resized to ``raw_shape`` (h, w) and scaled by (w / p_w,
  h / p_h), ``processed_shape`` (p_h, p_w) the size it was computed at."""
  h, w = raw_shape
  p_h, p_w = processed_shape
  flow = resize_bilinear(flow_collection[-1], (h, w))
  return flow * torch.tensor([w / p_w, h / p_h], dtype=flow.dtype,
                             device=flow.device)
