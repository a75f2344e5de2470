"""Observation SDEs for linear inverse problems.

Counterpart of the JAX package's ``inverse/obsv_sde.py``: the observation
process y_t = alpha(t) y_0 + beta(t) A z of a linear operator A, with
(alpha, beta) the state SDE's marginal coefficients.  As there, only what
the conditional samplers use is defined.
"""

from __future__ import annotations

import abc

from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.inverse.operators import LinearOperator


class OBSVSDE(abc.ABC):
  """Observation-SDE base: ``N`` steps, the observation ``y0`` and the
  operator."""

  def __init__(self, N: int, y0, operator: LinearOperator):
    self.N = N
    self.y0 = y0
    self.operator = operator

  @abc.abstractmethod
  def observe_sampling(self, z, t):
    """A sample of the observation process at ``t`` from the noise ``z``."""


class LOBSVSDE(OBSVSDE):
  """Linear-observation SDE over ``state_sde``."""

  def __init__(self, state_sde: sde_lib.SDE, y0, operator: LinearOperator):
    super().__init__(state_sde.N, y0, operator)
    self.state_sde = state_sde

  @property
  def T(self):
    return 1.0

  def marginal_prob(self, z, t):
    alpha, beta = self.state_sde.marginal_coef(t)
    return alpha[:, None, None] * self.y0, beta

  def observe_sampling(self, z, t):
    """y_t (B, C, N) from the image-shaped noise ``z`` at times ``t``
    (B,)."""
    alpha, beta = self.state_sde.marginal_coef(t)
    return (alpha[:, None, None] * self.y0
            + beta[:, None, None] * self.operator(z, keep_shape=False))


def get_obsvsde(config, y0, operator: LinearOperator):
  """(the observation SDE of ``config``'s sampler, the sampling eps)."""
  sde, sampling_eps = sde_lib.get_sde(config)
  if config.inverse.sampler in ('controlled', 'dps'):
    return LOBSVSDE(sde, y0, operator), sampling_eps
  raise NotImplementedError
