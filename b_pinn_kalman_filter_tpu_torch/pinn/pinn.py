"""PINN: flow + pressure composition.

Counterpart of the JAX package's ``pinn/pinn.py`` (the forward model; the
residual losses come with PINN training).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from b_pinn_kalman_filter_tpu_torch.models.flownet import (FlowNet,
                                                           PressureNet,
                                                           project)


def get_flow_model(config) -> nn.Module:
  """The flow network of ``config.model.arch``; only 'flownet' is ported."""
  arch = config.model.arch
  if arch == 'flownet':
    return FlowNet(config)
  if arch in ('liteflownet', 'unet', 'mlp'):
    raise NotImplementedError(f'model.arch {arch!r} is not ported yet')
  raise NotImplementedError(f'unknown model.arch {arch!r}')


class PINN(nn.Module):
  """f1, f2 (B, H, W, 1) consecutive frames, x, y (B, H, W, 1) coordinate
  fields, t (B,) times -> (cascaded flows, pressure (B, H, W, 1))."""

  def __init__(self, config):
    super().__init__()
    self.config = config
    self.flownet = get_flow_model(config)
    self.pressurenet = PressureNet(config)

  def forward(self, f1, f2, x, y, t, size=None):
    flow = self.flownet(f1, f2, x, y, t, size=size)
    return flow, self.pressurenet(flow, x, y, t)


def pinn_step(ft: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
  """Density advection by the predicted flow."""
  return project(ft, u, dt)
