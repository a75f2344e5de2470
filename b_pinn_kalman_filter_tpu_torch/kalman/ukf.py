"""Square-root Unscented Kalman Filter over N independent filters.

Counterpart of the JAX package's ``kalman/ukf.py``: Merwe sigma points
(alpha 1, beta 0, kappa 0), a QR square-root predict and a QR square-root
measurement update with no covariance subtraction.  The JAX package vmaps
the dynamics over the sigma-point axis; here that axis is a batch axis of
the dynamics function, which gets all 2n+1 sigma points at once.  The
batched linear algebra (QR, Cholesky, solves, einsums) is library code, as
it is XLA's in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class MerweWeights(NamedTuple):
  wm: np.ndarray      # (2n+1,) mean weights
  wc: np.ndarray      # (2n+1,) covariance weights
  scale: float        # sqrt(n + lambda)


def merwe_weights(n: int, alpha: float = 1.0, beta: float = 0.0,
                  kappa: float = 0.0) -> MerweWeights:
  lam = alpha ** 2 * (n + kappa) - n
  wm = np.full(2 * n + 1, 1.0 / (2 * (n + lam)))
  wc = wm.copy()
  wm[0] = lam / (n + lam)
  wc[0] = lam / (n + lam) + (1 - alpha ** 2 + beta)
  return MerweWeights(wm=wm, wc=wc, scale=float(np.sqrt(n + lam)))


@dataclass
class UKFBelief:
  """Belief over N independent filters of dimension n."""
  mean: Tensor       # (N, n)
  sqrt_cov: Tensor   # (N, n, n) lower-triangular, nonnegative diagonal


def initialize_beliefs(mean: Tensor, covariance: Tensor) -> UKFBelief:
  return UKFBelief(mean=mean, sqrt_cov=torch.linalg.cholesky(covariance))


def sigma_points(belief: UKFBelief, w: MerweWeights) -> Tensor:
  """Merwe sigma points, (2n+1, N, n): the mean, then mean +- the scaled
  columns of the sqrt covariance."""
  offsets = (w.scale * belief.sqrt_cov).permute(2, 0, 1)   # (n, N, n)
  mean = belief.mean[None]
  return torch.cat([mean, mean + offsets, mean - offsets], dim=0)


def _weights(values: np.ndarray, like: Tensor) -> Tensor:
  return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def _qr_sqrt(deviations: Tensor, extra_rows: Tensor) -> Tensor:
  """Lower-triangular sqrt covariance, nonnegative diagonal, from the QR of
  the rows ``[deviations (N, s, n); extra_rows (N, k, n)]``."""
  stacked = torch.cat([deviations, extra_rows], dim=1)      # (N, s+k, n)
  r = torch.linalg.qr(stacked, mode='r').R                  # (N, n, n)
  sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
  sign = torch.where(sign == 0, 1.0, sign)                  # sign(0) = +1
  return (r * sign[..., :, None]).transpose(1, 2)


def predict(belief: UKFBelief, w: MerweWeights,
            dynamics_fn: Callable[[Tensor], Tuple[Tensor, Tensor]]
            ) -> Tuple[UKFBelief, Tensor]:
  """UKF predict.  ``dynamics_fn(states (S, N, n)) -> (next (S, N, n),
  sqrt_Q (N, n, n))`` steps all S sigma points at once; sqrt_Q does not
  depend on the states.  Returns (predicted belief, propagated points)."""
  X = sigma_points(belief, w)                               # (S, N, n)
  Xp, sqrt_q = dynamics_fn(X)
  wm = _weights(w.wm, Xp)
  mean = torch.einsum('s,snd->nd', wm, Xp)
  wc = _weights(w.wc, Xp)
  dev = Xp - mean[None]
  dev_rows = (torch.sqrt(torch.clamp(wc, min=0.0))[:, None, None] * dev)
  sqrt_cov = _qr_sqrt(dev_rows.transpose(0, 1), sqrt_q.transpose(1, 2))
  return UKFBelief(mean=mean, sqrt_cov=sqrt_cov), Xp


def update(belief: UKFBelief, Xp: Tensor, w: MerweWeights,
           observation: Tensor,
           measurement_fn: Callable[[Tensor], Tuple[Tensor, Tensor]]
           ) -> UKFBelief:
  """Square-root measurement update.  ``measurement_fn(states (S, N, n))
  -> (pred_obs (S, N, m), R (N, m, m))``, R independent of the states.

  K = Pxz Pzz^-1 by Cholesky solves; the posterior sqrt covariance is the
  QR of ``[sqrt(wc_i) (dx_i - K dz_i); (K sqrt(R))^T]``.
  """
  wm = _weights(w.wm, Xp)
  wc = _weights(w.wc, Xp)
  Z, R = measurement_fn(Xp)                                 # (S, N, m)
  z_mean = torch.einsum('s,snm->nm', wm, Z)
  dz = Z - z_mean[None]
  dx = Xp - belief.mean[None]

  Pzz = torch.einsum('s,snm,snk->nmk', wc, dz, dz) + R
  Pxz = torch.einsum('s,snd,snm->ndm', wc, dx, dz)
  chol = torch.linalg.cholesky(Pzz)
  K = torch.cholesky_solve(Pxz.transpose(1, 2), chol).transpose(1, 2)

  mean = belief.mean + torch.einsum('ndm,nm->nd', K, observation - z_mean)
  resid = dx - torch.einsum('ndm,snm->snd', K, dz)
  rows = torch.sqrt(torch.clamp(wc, min=0.0))[:, None, None] * resid
  k_sqrt_r_t = torch.einsum('ndm,nmk->nkd', K, torch.linalg.cholesky(R))
  return UKFBelief(mean=mean,
                   sqrt_cov=_qr_sqrt(rows.transpose(0, 1), k_sqrt_r_t))


def ukf_step(belief: UKFBelief, observation: Tensor, w: MerweWeights,
             dynamics_fn: Callable, measurement_fn: Callable) -> UKFBelief:
  """Predict, redraw the sigma points from the predicted belief (so they
  carry the process noise), update."""
  pred_belief, _ = predict(belief, w, dynamics_fn)
  Xp = sigma_points(pred_belief, w)
  return update(pred_belief, Xp, w, observation, measurement_fn)
