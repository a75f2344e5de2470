"""PINN: flow + pressure composition.

Counterpart of the JAX package's ``pinn/pinn.py``: the forward model and
its two halves, ``flow_only`` and ``pressure_only`` (the NS residual comes
with phase 2 of PINN training, ROADMAP.md A.2).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
from torch.func import functional_call

from b_pinn_kalman_filter_tpu_torch.models.flownet import (FlowNet,
                                                           PressureNet,
                                                           project)


def get_flow_model(config, kernels: bool = True) -> nn.Module:
  """The flow network of ``config.model.arch``; only 'flownet' is ported.
  ``kernels`` selects the cost volume's kernel or its plain version."""
  arch = config.model.arch
  if arch == 'flownet':
    return FlowNet(config, kernels)
  if arch in ('liteflownet', 'unet', 'mlp'):
    raise NotImplementedError(f'model.arch {arch!r} is not ported yet')
  raise NotImplementedError(f'unknown model.arch {arch!r}')


class PINN(nn.Module):
  """f1, f2 (B, H, W, 1) consecutive frames, x, y (B, H, W, 1) coordinate
  fields, t (B,) times -> (cascaded flows, pressure (B, H, W, 1)).

  ``flow_only`` and ``pressure_only`` run one half, under ``params`` (the
  PINN's ``{'flownet.<name>' | 'pressurenet.<name>': tensor}``, as a train
  state holds them) where given, else under the module's own parameters.
  """

  def __init__(self, config, kernels: bool = True):
    super().__init__()
    self.config = config
    self.flownet = get_flow_model(config, kernels)
    self.pressurenet = PressureNet(config)

  def forward(self, f1, f2, x, y, t, size=None):
    flow = self.flownet(f1, f2, x, y, t, size=size)
    return flow, self.pressurenet(flow, x, y, t)

  def flow_only(self, f1, f2, x, y, t, size=None,
                params: Optional[Dict[str, torch.Tensor]] = None):
    return _call(self.flownet, 'flownet', params, (f1, f2, x, y, t),
                 {'size': size})

  def pressure_only(self, cascaded_flow, x, y, t,
                    params: Optional[Dict[str, torch.Tensor]] = None):
    return _call(self.pressurenet, 'pressurenet', params,
                 (cascaded_flow, x, y, t), {})


def _call(module: nn.Module, key: str, params, args, kwargs):
  """``module(*args, **kwargs)``, under the entries ``key.<name>`` of
  ``params`` where given."""
  if params is None:
    return module(*args, **kwargs)
  prefix = key + '.'
  own = {name[len(prefix):]: value for name, value in params.items()
         if name.startswith(prefix)}
  return functional_call(module, own, args, kwargs, strict=True)


def pinn_step(ft: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
  """Density advection by the predicted flow."""
  return project(ft, u, dt)
