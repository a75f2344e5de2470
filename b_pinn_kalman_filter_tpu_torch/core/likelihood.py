"""Probability-flow-ODE log-likelihood in bits/dim.

Counterpart of the JAX package's ``core/likelihood.py``.  The Hutchinson
divergence eps^T (d drift / dx) eps is the forward-mode tangent of the
drift along eps, and the drift is the primal of that same pass: one pass
of the score net with a tangent per evaluation (JAX's ``jit`` removes its
separate drift pass; eager PyTorch would run it twice).  The pass takes
``torch.autograd.forward_ad``'s dual tensors, not ``torch.func.jvp``: the
two compute the same bits, but functorch wraps every op and generates a
class for every autograd Function call, which made an evaluation of the
flagship U-Net 1.7 to 2.1 times slower on the card (``PERF.md`` §6).
On the card the pass runs K1 and K2 with their forward-mode rules
(``ops/conv3x3.py``, ``ops/groupnorm.py``): K1 twice a site (x and its
tangent), K2 and the K2 JVP kernel once a site.  The state is packed as
JAX packs it, x flattened and then delta log p, because the
Dormand–Prince error norm is an RMS over the whole packed vector;
``core/ode.py`` ``odeint_dopri`` integrates it from ``eps`` to ``sde.T``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from b_pinn_kalman_filter_tpu_torch.core import ode as ode_lib
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils


def get_drift_div_fn(fn: Callable) -> Callable:
  """``drift_div_fn(x, t, eps) -> (fn(x, t), eps^T (d fn / dx) eps)``, the
  second per batch element, both from one forward-mode pass."""

  def drift_div_fn(x, t, eps):
    with fwAD.dual_level():
      drift, jvp_val = fwAD.unpack_dual(fn(fwAD.make_dual(x, eps), t))
    if jvp_val is None:         # fn does not depend on x
      jvp_val = torch.zeros_like(drift)
    return drift, torch.sum((jvp_val * eps).reshape(x.shape[0], -1), dim=-1)

  return drift_div_fn


def get_div_fn(fn: Callable) -> Callable:
  """The Hutchinson–Skilling divergence estimator ``div_fn(x, t, eps)``
  (JAX ``get_div_fn``)."""
  drift_div_fn = get_drift_div_fn(fn)

  def div_fn(x, t, eps):
    return drift_div_fn(x, t, eps)[1]

  return div_fn


def get_likelihood_fn(sde, model, inverse_scaler,
                      hutchinson_type: str = 'Rademacher',
                      rtol: float = 1e-5, atol: float = 1e-5,
                      eps: float = 1e-5) -> Callable:
  """``likelihood_fn(params, data, generator=None, epsilon=None) -> (bpd,
  z, nfe)`` for the score model ``model`` under ``params`` (a ``{flax
  name: tensor}`` dict, or None for the module's own)."""
  core = get_likelihood_fn_from_score(sde, inverse_scaler, hutchinson_type,
                                      rtol, atol, eps)

  def likelihood_fn(params, data, generator=None, epsilon=None):
    # Detached, so that no autograd graph keeps the sites' inputs alive.
    params = dict(model.named_parameters()) if params is None else params
    score_fn = mutils.get_score_fn(
        sde, model, train=False, continuous=True,
        params={name: p.detach() for name, p in params.items()})
    return core(score_fn, data, generator=generator, epsilon=epsilon)

  return likelihood_fn


def get_likelihood_fn_from_score(sde, inverse_scaler,
                                 hutchinson_type: str = 'Rademacher',
                                 rtol: float = 1e-5, atol: float = 1e-5,
                                 eps: float = 1e-5) -> Callable:
  """The likelihood core on an explicit score function:
  ``fn(score_fn, data, generator=None, epsilon=None) -> (bpd, z, nfe)``.

  The probe ``epsilon`` is drawn from ``generator`` (Rademacher signs or
  standard normals, in the data's dtype) unless given.  Runs without
  autograd's graph; ``nfe`` counts drift-and-divergence evaluations.
  """
  if hutchinson_type not in ('Gaussian', 'Rademacher'):
    raise NotImplementedError(f'Hutchinson type {hutchinson_type} unknown.')

  def likelihood_fn(score_fn, data: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    epsilon: Optional[torch.Tensor] = None):
    shape = tuple(data.shape)
    batch = shape[0]
    if epsilon is None:
      if hutchinson_type == 'Gaussian':
        epsilon = torch.randn(shape, generator=generator,
                              device=data.device, dtype=data.dtype)
      else:
        epsilon = (torch.randint(0, 2, shape, generator=generator,
                                 device=data.device) * 2 - 1).to(data.dtype)
    epsilon = epsilon.to(device=data.device, dtype=data.dtype)
    rsde = sde.reverse(score_fn, probability_flow=True)
    drift_div_fn = get_drift_div_fn(lambda x, t: rsde.sde(x, t)[0])

    def packed_ode(t, y):
      x = y[:-batch].reshape(shape)
      vec_t = torch.full((batch,), float(t), dtype=y.dtype, device=y.device)
      drift, logp_grad = drift_div_fn(x, vec_t, epsilon)
      return torch.cat([drift.reshape(-1).to(y.dtype), logp_grad.to(y.dtype)])

    with torch.no_grad():
      init = torch.cat([data.reshape(-1),
                        torch.zeros((batch,), dtype=data.dtype,
                                    device=data.device)])
      result = ode_lib.odeint_dopri(packed_ode, init, eps, sde.T, rtol=rtol,
                                    atol=atol)
      z = result.y[:-batch].reshape(shape)
      delta_logp = result.y[-batch:]
      prior_logp = sde.prior_logp(z)
      bpd = -(prior_logp + delta_logp) / np.log(2)
      bpd = bpd / np.prod(shape[1:])
      # Log-likelihoods of scaled data to bits/dim of raw data.
      offset = 7.0 - inverse_scaler(-1.0)
      return bpd + offset, z, result.nfe

  return likelihood_fn
