"""Bias plus (leaky) ReLU times a gain, NHWC (the bias on the channel
axis).

Counterpart of the JAX package's ``ops/fused_act.py``: an elementwise
chain, plain PyTorch here as it is plain XLA there.  No score network
calls it; it is kept with the FIR ops, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.models import layers


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                     negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5) -> torch.Tensor:
  """``leaky_relu(x + bias) * scale``."""
  return F.leaky_relu(x + bias, negative_slope) * scale


def fused_bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   act: str = 'linear', alpha: float = 0.2,
                   gain: float = 1.0) -> torch.Tensor:
  """``act(x + bias) * gain``, ``act`` one of 'linear', 'relu', 'lrelu'
  (slope ``alpha``)."""
  if bias is not None:
    x = x + bias
  if act == 'relu':
    x = F.relu(x)
  elif act == 'lrelu':
    x = F.leaky_relu(x, alpha)
  elif act != 'linear':
    raise NotImplementedError(f'act {act} unknown')
  return x * gain


class FusedLeakyReLU(nn.Module):
  """:func:`fused_leaky_relu` with a learned channel ``bias`` (zeros at
  init)."""

  def __init__(self, channel: int, negative_slope: float = 0.2,
               scale: float = 2 ** 0.5):
    super().__init__()
    self.negative_slope, self.scale = negative_slope, scale
    layers._param(self, 'bias', (channel,), layers.zeros_init)

  def forward(self, x):
    return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
