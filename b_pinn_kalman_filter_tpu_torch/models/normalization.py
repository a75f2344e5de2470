"""Normalization layers, NHWC.  Counterpart of the JAX package's
``models/normalization.py``; only what the PressureNet uses so far."""

from __future__ import annotations

import torch
import torch.nn as nn


class InstanceNorm2d(nn.Module):
  """Per-image, per-channel norm over (H, W) without affine: biased
  variance, eps 1e-5 (torch ``InstanceNorm2d``)."""

  def __init__(self, epsilon: float = 1e-5):
    super().__init__()
    self.epsilon = epsilon

  def forward(self, x):
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + self.epsilon)
