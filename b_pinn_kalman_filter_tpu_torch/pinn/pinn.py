"""PINN: flow + pressure composition, and the Navier–Stokes residual.

Counterpart of the JAX package's ``pinn/pinn.py``: the forward model, its
two halves ``flow_only`` and ``pressure_only``, and the residual loss
``equation_mse`` of phase 2 of PINN training.  The residual takes the
derivatives of the net's (u, v, p) with respect to its coordinate inputs
x, y, t by nested ``torch.autograd.grad`` with ``create_graph``, so that
the loss's parameter gradient is a third derivative; on the card each
cost volume then runs K3, B1 and B2 at up to third order
(``ops/correlation.py``).  The shared-linearisation schedule of the JAX
``equation_mse_fused`` is not ported (ROADMAP.md A.14).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.func import functional_call

from b_pinn_kalman_filter_tpu_torch.models.flownet import (FlowNet,
                                                           PressureNet,
                                                           project)
from b_pinn_kalman_filter_tpu_torch.models.liteflownet import LiteFlowNet


def get_flow_model(config, kernels: bool = True) -> nn.Module:
  """The flow network of ``config.model.arch``: 'flownet' or
  'liteflownet'.  ``kernels`` selects the cost volume's kernel or its
  plain version.  'unet' and 'mlp' raise: neither takes the PINN's ``(f1,
  f2, x, y, t, size)`` call, and the JAX package's PINN crashes on them
  too."""
  arch = config.model.arch
  if arch == 'flownet':
    return FlowNet(config, kernels)
  if arch == 'liteflownet':
    return LiteFlowNet(config, kernels)
  if arch in ('unet', 'mlp'):
    raise NotImplementedError(
        f'model.arch {arch!r} is not ported as a flow model: it does not '
        'take the PINN\'s (f1, f2, x, y, t) call')
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


def _call(module: nn.Module, key: Optional[str], params, args, kwargs):
  """``module(*args, **kwargs)``, under the entries ``key.<name>`` of
  ``params`` (all of them for ``key`` None) where given."""
  if params is None:
    return module(*args, **kwargs)
  if key is not None:
    prefix = key + '.'
    params = {name[len(prefix):]: value for name, value in params.items()
              if name.startswith(prefix)}
  return functional_call(module, params, args, kwargs, strict=True)


def pinn_step(ft: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
  """Density advection by the predicted flow."""
  return project(ft, u, dt)


def _grad(out: torch.Tensor, inputs: Sequence[torch.Tensor],
          create_graph: bool):
  """``d out.sum() / d inputs``, zeros for an input ``out`` does not reach
  (as ``jax.grad`` gives them)."""
  if not out.requires_grad:
    return tuple(torch.zeros_like(i) for i in inputs)
  return torch.autograd.grad(out.sum(), inputs, retain_graph=True,
                             create_graph=create_graph, allow_unused=True,
                             materialize_grads=True)


def equation_mse(apply_uvp: Callable, x: torch.Tensor, y: torch.Tensor,
                 t: torch.Tensor, Re: float, create_graph: bool = True,
                 trace: Optional[Callable[[str], None]] = None
                 ) -> torch.Tensor:
  """Incompressible-NS residual loss of ``apply_uvp(x, y, t) -> (u, v,
  p)``, x, y (B, H, W, 1) coordinate fields, t (B,) times.

  The JAX ``equation_mse``'s literal schedule, the torch way: one forward
  on fresh leaves x, y, t, then sum-then-grad partials: ``u_x, u_y, u_t``
  of ``u.sum()``, the same of ``v``, ``p_x, p_y`` of ``p.sum()`` (not of
  t), and ``u_xx = d u_x.sum() / dx`` and so on, the Hessian's row sums
  (not its diagonal), as the JAX package's nested ``jax.grad`` gives them.
  ``u_t`` and ``v_t`` are (B,) and broadcast over space.

  With ``create_graph`` the result carries the graph of every derivative,
  for a gradient with respect to the parameters ``apply_uvp`` closes over;
  without it only the first derivatives keep theirs (the second need it),
  which is what an evaluation takes.  Runs with grad enabled whatever the
  caller's mode.  ``trace(stage)``, where given, is called after the
  forward (``'forward'``), the first derivatives (``'first'``) and the
  second (``'second'``), so that a caller can read the kernels' launch
  counts by stage.
  """
  with torch.enable_grad():
    x, y, t = (c.detach().requires_grad_() for c in (x, y, t))
    u, v, p = apply_uvp(x, y, t)
    if trace:
      trace('forward')
    u_x, u_y, u_t = _grad(u, (x, y, t), True)
    v_x, v_y, v_t = _grad(v, (x, y, t), True)
    p_x, p_y = _grad(p, (x, y), create_graph)
    if trace:
      trace('first')
    (u_xx,), (u_yy,) = _grad(u_x, (x,), create_graph), _grad(u_y, (y,),
                                                            create_graph)
    (v_xx,), (v_yy,) = _grad(v_x, (x,), create_graph), _grad(v_y, (y,),
                                                            create_graph)
    if trace:
      trace('second')
    u_t = u_t[:, None, None, None]
    v_t = v_t[:, None, None, None]
    f_x = u_t + (u * u_x + v * u_y) + p_x - 1.0 / Re * (u_xx + u_yy)
    f_y = v_t + (u * v_x + v * v_y) + p_y - 1.0 / Re * (v_xx + v_yy)
    f_mass = u_x + v_y
    loss = (torch.mean(f_x ** 2) + torch.mean(f_y ** 2)
            + torch.mean(f_mass ** 2))
  return loss if create_graph else loss.detach()


def make_uvp_fn(model: PINN, params: Optional[Dict[str, torch.Tensor]],
                f1: torch.Tensor, f2: torch.Tensor) -> Callable:
  """The function ``(x, y, t) -> (u, v, p)`` of the PINN on frames f1, f2
  under ``params`` (its flat names; the module's own where None): u and v
  the two channels of the full-resolution flow, p the pressure."""

  def apply_uvp(x, y, t):
    flow, pres = _call(model, None, params, (f1, f2, x, y, t), {})
    fin = flow[-1]
    return fin[..., 0:1], fin[..., 1:2], pres

  return apply_uvp


def equation_mse_from_outputs(model: PINN, params, f1, f2, x, y, t,
                              Re: float, fused: bool = False,
                              create_graph: bool = True,
                              trace: Optional[Callable[[str], None]] = None
                              ) -> torch.Tensor:
  """:func:`equation_mse` of the PINN on frames f1, f2 under ``params``,
  recomputing the forward on the coordinate leaves."""
  if fused:
    raise NotImplementedError(
        'equation_mse_fused (the shared-vjp schedule) is not ported yet: '
        'ROADMAP.md A.14')
  return equation_mse(make_uvp_fn(model, params, f1, f2), x, y, t, Re,
                      create_graph=create_graph, trace=trace)
