"""NCSN and NCSNv2 RefineNet score networks in PyTorch, NHWC.

Counterpart of the JAX package's ``models/ncsnv2.py``: ``ncsnv2_64``
(``NCSNv2``, images under 96px), ``ncsn`` (``NCSN``, the class-conditional
v1), ``ncsnv2_128`` and ``ncsnv2_256``, with the flax child names
(``NCSNConv_k``, ``ResidualBlock_k`` / ``ConditionalResidualBlock_k``,
``RefineBlock_k`` / ``CondRefineBlock_k``, the final norm), so the
parameters carry across by name.  f32 throughout: the JAX modules read no
``tpu.compute_dtype``, and they have no Pallas site (their convs are XLA's,
cuDNN's ``F.conv2d`` here; their norms plain ops).  The NCSNv2 variants
divide their output by ``sigmas[labels]`` (the noise level's index, cast
to an integer); ``ncsn`` does not, and reads ``model.num_classes`` for its
conditional norms.
"""

from __future__ import annotations

import functools

import torch

from b_pinn_kalman_filter_tpu_torch.models import layers, normalization
from b_pinn_kalman_filter_tpu_torch.models import registry
from b_pinn_kalman_filter_tpu_torch.models.layers_ncsn import (
    ConditionalResidualBlock, CondRefineBlock, FlaxNamed, NCSNConv,
    RefineBlock, ResidualBlock)


def _channels(config):
  # The reference's configs call it data.channels; these num_channels.
  return getattr(config.data, 'channels', None) or config.data.num_channels


def get_network(config):
  """The NCSNv2 variant for ``data.image_size``."""
  if config.data.image_size < 96:
    return functools.partial(NCSNv2, config=config)
  elif 96 <= config.data.image_size <= 128:
    return functools.partial(NCSNv2_128, config=config)
  elif 128 < config.data.image_size <= 256:
    return functools.partial(NCSNv2_256, config=config)
  raise NotImplementedError(
      f'No network suitable for {config.data.image_size}px implemented yet.')


class _RefineNet(FlaxNamed):
  """The NCSNv2 trunk: the input conv, the stages of residual pairs (a
  resampling block, then a plain one), the RefineNet blocks from the
  coarsest up, the final norm, act and conv, and the division by the
  labels' sigmas.

  ``stages`` is ``[(width multiple, resample, dilation)]``, finest first;
  ``refine`` the RefineNet blocks' width multiples, coarsest first (the
  last one ``end``); with ``adjust_last`` the last stage's resampling
  block takes ``adjust_padding`` at 28px, as in JAX (its dilated branch
  ignores it).
  """

  stages = ()
  refine = ()
  adjust_last = False

  def __init__(self, config, kernels: bool = True):
    super().__init__()
    del kernels      # no kernel site
    self.config = config
    self.act = act = layers.get_act(config)
    norm = normalization.get_normalization(config)
    nf = config.model.nf
    self.add(NCSNConv(_channels(config), nf))                  # NCSNConv_0
    self.trunk = []
    width = nf
    for i, (mult, resample, dilation) in enumerate(self.stages):
      out = mult * nf
      adjust = (self.adjust_last and i == len(self.stages) - 1
                and config.data.image_size == 28)
      self.trunk.append((
          self.add(ResidualBlock(width, out, norm, resample=resample,
                                 act=act, adjust_padding=adjust,
                                 dilation=dilation)),
          self.add(ResidualBlock(out, out, norm, act=act,
                                 dilation=dilation))))
      width = out
    widths = [mult * nf for mult, _, _ in self.stages][::-1]
    self.refines = []
    for i, mult in enumerate(self.refine):
      planes = [widths[0]] if i == 0 else [widths[i], self.refine[i - 1] * nf]
      self.refines.append(self.add(RefineBlock(
          planes, mult * nf, act, start=i == 0,
          end=i == len(self.refine) - 1)))
    self.head = (self.add(norm(self.refine[-1] * nf)),
                 self.add(NCSNConv(self.refine[-1] * nf,     # NCSNConv_1
                                   _channels(config))))
    self.register_buffer('sigmas', torch.tensor(
        registry.get_sigmas(config), dtype=torch.float32), persistent=False)

  def forward(self, x, labels, train=True, generator=None):
    h = x if self.config.data.centered else 2 * x - 1.
    h = self.NCSNConv_0(h)
    layers_out = []
    for first, second in self.trunk:
      h = second(first(h))
      layers_out.append(h)
    layers_out = layers_out[::-1]
    ref = None
    for i, block in enumerate(self.refines):
      xs = [layers_out[i]] if ref is None else [layers_out[i], ref]
      ref = block(xs, layers_out[i].shape[1:3])
    norm, conv = self.head
    h = conv(self.act(norm(ref)))
    # JAX's gather clamps an index past the end (a continuous VE loss
    # feeds sigmas as labels: ``ve/ncsnv2/bedroom``).
    idx = labels.long().clamp(0, self.sigmas.shape[0] - 1)
    return h / self.sigmas[idx][:, None, None, None]


@registry.register_model(name='ncsnv2_64')
class NCSNv2(_RefineNet):
  """NCSNv2 for images under 96px: 4 stages (nf, 2 nf down, 2 nf down
  dilated 2, 2 nf down dilated 4)."""

  stages = ((1, None, 1), (2, 'down', 1), (2, 'down', 2), (2, 'down', 4))
  refine = (2, 2, 1, 1)
  adjust_last = True


@registry.register_model(name='ncsnv2_128')
class NCSNv2_128(_RefineNet):
  """NCSNv2 for 96-128px images: 5 stages, the last two 4 nf dilated."""

  stages = ((1, None, 1), (2, 'down', 1), (2, 'down', 1), (4, 'down', 2),
            (4, 'down', 4))
  refine = (4, 2, 2, 1, 1)


@registry.register_model(name='ncsnv2_256')
class NCSNv2_256(_RefineNet):
  """NCSNv2 for 129-256px images: 6 stages."""

  stages = ((1, None, 1), (2, 'down', 1), (2, 'down', 1), (2, 'down', 1),
            (4, 'down', 2), (4, 'down', 4))
  refine = (4, 2, 2, 2, 1, 1)


@registry.register_model(name='ncsn')
class NCSN(FlaxNamed):
  """The original class-conditional NCSN: ``ncsnv2_64``'s trunk with
  conditional residual and RefineNet blocks and norms (labels are class
  indices), no division by sigma."""

  def __init__(self, config, kernels: bool = True):
    super().__init__()
    del kernels      # no kernel site
    self.config = config
    self.act = act = layers.get_act(config)
    norm = normalization.get_normalization(config, conditional=True)
    nf = config.model.nf
    self.add(NCSNConv(_channels(config), nf))                  # NCSNConv_0
    self.trunk = []
    width = nf
    for i, (mult, resample, dilation) in enumerate(NCSNv2.stages):
      out = mult * nf
      adjust = i == len(NCSNv2.stages) - 1 and config.data.image_size == 28
      self.trunk.append((
          self.add(ConditionalResidualBlock(
              width, out, norm, resample=resample, act=act,
              adjust_padding=adjust, dilation=dilation)),
          self.add(ConditionalResidualBlock(out, out, norm, act=act,
                                            dilation=dilation))))
      width = out
    self.refines = [
        self.add(CondRefineBlock([2 * nf], 2 * nf, norm, act, start=True)),
        self.add(CondRefineBlock([2 * nf, 2 * nf], 2 * nf, norm, act)),
        self.add(CondRefineBlock([2 * nf, 2 * nf], nf, norm, act)),
        self.add(CondRefineBlock([nf, nf], nf, norm, act, end=True))]
    self.add(norm(nf))               # ConditionalInstanceNorm2dPlus_0
    self.add(NCSNConv(nf, _channels(config)))                  # NCSNConv_1

  def forward(self, x, labels, train=True, generator=None):
    y = labels.long()
    h = x if self.config.data.centered else 2 * x - 1.
    h = self.NCSNConv_0(h)
    layers_out = []
    for first, second in self.trunk:
      h = second(first(h, y), y)
      layers_out.append(h)
    layers_out = layers_out[::-1]
    ref = None
    for i, block in enumerate(self.refines):
      xs = [layers_out[i]] if ref is None else [layers_out[i], ref]
      ref = block(xs, y, layers_out[i].shape[1:3])
    h = self.act(self.ConditionalInstanceNorm2dPlus_0(ref, y))
    return self.NCSNConv_1(h)
