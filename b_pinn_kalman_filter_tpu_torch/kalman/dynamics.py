"""UKF dynamics and measurement models on patch states.

Counterpart of the JAX package's ``kalman/dynamics.py`` (``NSDynamics``,
``IdentityKFMeasure``).  Both take a stack of states (S, N, n), the
sigma-point axis first, where the JAX package vmaps over it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from b_pinn_kalman_filter_tpu_torch.kalman.patching import (patch,
                                                            patch_stack,
                                                            unpatch_stack)
from b_pinn_kalman_filter_tpu_torch.ops import ns_step

Tensor = torch.Tensor

NS_DT = 0.0005 * 5
NS_DX = 1.0 / 200
PROCESS_NOISE = 1e-8


class NSDynamics:
  """Navier–Stokes dynamics on patched (f, u, v, p) states."""

  def __init__(self, config):
    self.dim = config.kf.patch_size
    self.size = config.data.image_size
    if self.size % self.dim:
      raise ValueError(f'patch size {self.dim} does not divide image size '
                       f'{self.size}')

  def __call__(self, states: Tensor) -> Tuple[Tensor, Tensor]:
    """states (S, N, p^2), all N patches of S states -> (next states,
    sqrt_Q (N, p^2, p^2)).

    The S states are unpatched one by one into an (S*B, H, W) batch per
    field and stepped by ONE call of kernel K4.  sqrt_Q is the constant
    sqrt(1e-8) I, built without stepping anything.
    """
    S, N, n = states.shape
    fields = unpatch_stack(states, self.dim, self.size, 4)   # (S, B, H, W, 4)
    B = fields.shape[1]
    f, u, v, p = (fields[..., c].reshape(S * B, self.size, self.size)
                  for c in range(4))
    f, u, v, p = ns_step.ns_step_fused(f, u, v, p, NS_DT, NS_DX)
    out = torch.stack([f, u, v, p], dim=-1).reshape(S, B, self.size,
                                                    self.size, 4)
    sqrt_q = (torch.eye(n, dtype=states.dtype, device=states.device)
              * PROCESS_NOISE ** 0.5).expand(N, n, n)
    return patch_stack(out, self.dim), sqrt_q


class IdentityKFMeasure:
  """Identity measurement with a covariance from the B-PINN's per-pixel
  uncertainty (f observed with the configured variance; u, v and p with the
  B-PINN's std squared).  The measurement function is deterministic."""

  def __init__(self, config):
    self.dim = config.kf.patch_size
    self.size = config.data.image_size
    self.var = config.inverse.variance
    self.uncer_flow: Optional[Tensor] = None
    self.uncer_pres: Optional[Tensor] = None

  def update_uncertainty(self, uncer_flow: Tensor, uncer_pres: Tensor):
    """Per-pixel B-PINN stds (B, H, W, 2) and (B, H, W, 1)."""
    if uncer_flow.shape[-1] != 2 or uncer_pres.shape[-1] != 1:
      raise ValueError(f'uncertainties {tuple(uncer_flow.shape)} and '
                       f'{tuple(uncer_pres.shape)} are not (..., 2), (..., 1)')
    self.uncer_flow = patch(uncer_flow, self.dim)
    self.uncer_pres = patch(uncer_pres, self.dim)

  def __call__(self, states: Tensor) -> Tuple[Tensor, Tensor]:
    """states (..., N, n) -> (states, R (N, n, n))."""
    n = self.dim ** 2
    N = states.shape[-2]
    eye = torch.eye(n, dtype=states.dtype, device=states.device)
    if self.uncer_flow is None:
      return states, (eye * self.var).expand(N, n, n)
    # States are ordered (channel, batch, patch): f, then u and v, then p.
    quarter = N // 4
    if (self.uncer_flow.shape[0] != 2 * quarter
        or self.uncer_pres.shape[0] != quarter):
      raise ValueError(f'uncertainties do not match {N} patch states')
    f_cov = (eye * self.var).expand(quarter, n, n)
    uv_cov = torch.diag_embed(self.uncer_flow ** 2)
    p_cov = torch.diag_embed(self.uncer_pres ** 2)
    return states, torch.cat([f_cov, uv_cov, p_cov], dim=0)

  def observe(self, generator: torch.Generator, f: Tensor) -> Tensor:
    """Noisy f-only observation: f + N(0, var), noise from ``generator``
    (which lives on f's device)."""
    noise = torch.randn(f.shape, generator=generator, dtype=f.dtype,
                        device=f.device)
    return f + noise * self.var ** 0.5
