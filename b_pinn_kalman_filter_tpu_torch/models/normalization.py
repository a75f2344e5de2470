"""Normalization layers of the NCSN models, NHWC.

Counterpart of the JAX package's ``models/normalization.py``, with its
parameter names: ``alpha``, ``gamma``, ``beta`` (each (C,)) and the
conditional norms' ``Embed_0.embedding`` (num_classes, k C), so
``convert.params_from_jax`` copies them name for name.  Every norm takes
its channel count first (the conditional ones also ``num_classes`` and
``bias``), so that a factory from :func:`get_normalization` builds one
with ``norm(C)``.  Spatial statistics are over (H, W); the variance over
the channel means is unbiased (torch's ``var``), the instance variance
biased (torch's ``InstanceNorm2d``), as in JAX.  f32.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn as nn

from b_pinn_kalman_filter_tpu_torch.models import layers


def get_normalization(config, conditional: bool = False):
  """The factory of ``config.model.normalization`` (with ``conditional``,
  its class-conditional version, which reads ``model.num_classes``)."""
  norm = config.model.normalization
  if conditional:
    if norm == 'InstanceNorm++':
      return functools.partial(ConditionalInstanceNorm2dPlus,
                               num_classes=config.model.num_classes)
    raise NotImplementedError(f'{norm} not implemented yet.')
  if norm == 'InstanceNorm':
    return InstanceNorm2d
  elif norm == 'InstanceNorm++':
    return InstanceNorm2dPlus
  elif norm == 'VarianceNorm':
    return VarianceNorm2d
  elif norm == 'GroupNorm':
    return lambda channels: layers.GroupNorm(channels, 32)
  else:
    raise ValueError('Unknown normalization: %s' % norm)


def _unbiased_var(x, dim, keepdim=False):
  return x.var(dim=dim, keepdim=keepdim, unbiased=True)


def instance_norm(x, epsilon: float = 1e-5):
  """Per-image, per-channel norm over (H, W): biased variance."""
  mean = x.mean(dim=(1, 2), keepdim=True)
  var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
  return (x - mean) / torch.sqrt(var + epsilon)


def _normalized_means(x):
  """The per-channel means of each image, normalized across channels
  (unbiased variance): (B, C)."""
  means = x.mean(dim=(1, 2))
  m = means.mean(dim=-1, keepdim=True)
  v = _unbiased_var(means, -1, keepdim=True)
  return (means - m) / torch.sqrt(v + 1e-5)


def _near_one(shape, generator):
  """1 + 0.02 N(0, 1): the JAX norms' scale init."""
  return 1 + 0.02 * torch.randn(tuple(shape), generator=generator)


def _uniform(shape, generator):
  return torch.rand(tuple(shape), generator=generator)


def _then_zeros(first, n: int):
  """An (num_classes, n + m) init: ``first`` for the first ``n`` columns,
  zeros for the rest (the beta part)."""

  def init(shape, generator):
    return torch.cat([first((shape[0], n), generator),
                      torch.zeros((shape[0], shape[1] - n))], dim=-1)

  return init


class Embed(nn.Module):
  """flax ``nn.Embed``: ``embedding`` (num_classes, features), rows taken
  by integer labels."""

  def __init__(self, num_classes: int, features: int, init):
    super().__init__()
    layers._param(self, 'embedding', (num_classes, features), init)

  def forward(self, y):
    return self.embedding[y.long()]


class InstanceNorm2d(nn.Module):
  """Per-channel instance norm without affine (torch ``InstanceNorm2d``)."""

  def __init__(self, channels: Optional[int] = None, epsilon: float = 1e-5):
    super().__init__()
    self.epsilon = epsilon

  def forward(self, x):
    return instance_norm(x, self.epsilon)


class VarianceNorm2d(nn.Module):
  """x over its unbiased per-channel standard deviation, times ``alpha``."""

  def __init__(self, channels: int, bias: bool = False):
    super().__init__()
    layers._param(self, 'alpha', (channels,), _near_one)

  def forward(self, x):
    vars_ = _unbiased_var(x, (1, 2), keepdim=True)
    return self.alpha * (x / torch.sqrt(vars_ + 1e-5))


class NoneNorm2d(nn.Module):

  def __init__(self, channels: Optional[int] = None):
    super().__init__()

  def forward(self, x):
    return x


class InstanceNorm2dPlus(nn.Module):
  """InstanceNorm++: instance norm with the normalized per-channel means
  added back through ``alpha``, then ``gamma`` and (with ``bias``)
  ``beta``."""

  def __init__(self, channels: int, bias: bool = True):
    super().__init__()
    layers._param(self, 'alpha', (channels,), _near_one)
    layers._param(self, 'gamma', (channels,), _near_one)
    if bias:
      layers._param(self, 'beta', (channels,), layers.zeros_init)
    else:
      self.beta = None

  def forward(self, x):
    means = _normalized_means(x)
    h = instance_norm(x) + means[:, None, None, :] * self.alpha
    if self.beta is None:
      return self.gamma * h
    return self.gamma * h + self.beta


def _affine(embed: Embed, y, h, parts: int):
  """``h`` scaled (and shifted) per class: the embedding row split in
  ``parts`` (gamma[, beta])."""
  chunks = torch.chunk(embed(y), parts, dim=-1)
  out = chunks[0][:, None, None, :] * h
  if parts == 2:
    out = out + chunks[1][:, None, None, :]
  return out


class _ConditionalAffine(nn.Module):
  """gamma[y] * norm(x) (+ beta[y] with ``bias``); the embedding's gamma
  part uniform in [0, 1), its beta part zeros."""

  def __init__(self, channels: int, num_classes: int, bias: bool = True):
    super().__init__()
    self.parts = 2 if bias else 1
    init = _then_zeros(_uniform, channels) if bias else _uniform
    self.Embed_0 = Embed(num_classes, channels * self.parts, init)

  def normalize(self, x):
    raise NotImplementedError

  def forward(self, x, y):
    return _affine(self.Embed_0, y, self.normalize(x), self.parts)


class ConditionalBatchNorm2d(_ConditionalAffine):
  """Class-conditional batch norm on the batch's statistics (biased
  variance, eps 1e-5)."""

  def normalize(self, x):
    mean = x.mean(dim=(0, 1, 2), keepdim=True)
    var = x.var(dim=(0, 1, 2), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-5)


class ConditionalInstanceNorm2d(_ConditionalAffine):
  """Class-conditional instance norm."""

  def normalize(self, x):
    return instance_norm(x)


class ConditionalNoneNorm2d(_ConditionalAffine):
  """The class-conditional affine map alone."""

  def normalize(self, x):
    return x


class ConditionalVarianceNorm2d(nn.Module):
  """Class-conditional variance norm: gamma[y] (init 1 + 0.02 N) times x
  over its unbiased per-channel standard deviation."""

  def __init__(self, channels: int, num_classes: int, bias: bool = False):
    super().__init__()
    self.Embed_0 = Embed(num_classes, channels, _near_one)

  def forward(self, x, y):
    vars_ = _unbiased_var(x, (1, 2), keepdim=True)
    return _affine(self.Embed_0, y, x / torch.sqrt(vars_ + 1e-5), 1)


class ConditionalInstanceNorm2dPlus(nn.Module):
  """Class-conditional InstanceNorm++: the embedding row is (gamma, alpha,
  beta) with ``bias``, else (gamma, alpha); gamma and alpha init 1 + 0.02
  N, beta zeros."""

  def __init__(self, channels: int, num_classes: int, bias: bool = True):
    super().__init__()
    self.bias = bias
    if bias:
      init = _then_zeros(_near_one, 2 * channels)
      self.Embed_0 = Embed(num_classes, channels * 3, init)
    else:
      self.Embed_0 = Embed(num_classes, channels * 2, _near_one)

  def forward(self, x, y):
    means = _normalized_means(x)
    h = instance_norm(x)
    emb = self.Embed_0(y)
    if self.bias:
      gamma, alpha, beta = torch.chunk(emb, 3, dim=-1)
    else:
      gamma, alpha = torch.chunk(emb, 2, dim=-1)
    h = h + means[:, None, None, :] * alpha[:, None, None, :]
    h = gamma[:, None, None, :] * h
    if self.bias:
      h = h + beta[:, None, None, :]
    return h
