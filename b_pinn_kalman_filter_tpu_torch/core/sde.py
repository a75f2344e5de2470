"""Forward / reverse SDE definitions (VP, sub-VP, VE) in PyTorch.

Counterpart of the JAX package's ``core/sde.py``.  Every method maps tensors
to tensors; per-batch scalars have shape ``(B,)`` and :func:`batch_mul`
broadcasts them against image tensors of any rank.  The discrete schedules
are float32 tensors made on the CPU and moved to ``t``'s device where they
are indexed.  Randomness is explicit: ``prior_sampling`` takes a
``torch.Generator``.
"""

from __future__ import annotations

import abc
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def batch_mul(a: Tensor, x: Tensor) -> Tensor:
  """Multiply per-batch scalars ``a`` of shape (B,) into ``x`` of shape (B, ...)."""
  a = torch.as_tensor(a)
  x = torch.as_tensor(x)
  return a.reshape(a.shape + (1,) * (x.ndim - a.ndim)) * x


def _sum_sq(z: Tensor) -> Tensor:
  return torch.sum(z.reshape(z.shape[0], -1) ** 2, dim=-1)


class SDE(abc.ABC):
  """Abstract SDE ``dx = f(x,t) dt + g(t) dW`` over a mini-batch."""

  def __init__(self, N: int):
    self.N = int(N)

  @property
  @abc.abstractmethod
  def T(self) -> float:
    """End time of the SDE."""

  @abc.abstractmethod
  def sde(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
    """Drift (B, ...) and diffusion (B,) at state ``x``, time ``t``."""

  @abc.abstractmethod
  def coefficient(self, t: Tensor) -> Tuple[Tensor, Tensor]:
    """Linear-SDE drift/diffusion coefficients at time ``t`` (both (B,))."""

  @abc.abstractmethod
  def marginal_coef(self, t: Tensor) -> Tuple[Tensor, Tensor]:
    """Marginal mean coefficient and std at time ``t`` (both (B,))."""

  def marginal_prob(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
    """Mean (B, ...) and std (B,) of the perturbation kernel p_t(x_t | x_0)."""
    mean_coef, std = self.marginal_coef(t)
    return batch_mul(mean_coef, x), std

  @abc.abstractmethod
  def prior_sampling(self, shape: Sequence[int], *,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> Tensor:
    """Sample from the prior p_T."""

  @abc.abstractmethod
  def prior_logp(self, z: Tensor) -> Tensor:
    """Log-density of the prior at ``z``; returns (B,)."""

  def discretize(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
    """Euler–Maruyama discretization: x_{i+1} = x_i + f_i(x_i) + G_i z_i."""
    dt = 1.0 / self.N
    drift, diffusion = self.sde(x, t)
    f = drift * dt
    G = diffusion * float(np.sqrt(dt))
    return f, G

  def reverse(self, score_fn: Callable[[Tensor, Tensor], Tensor],
              probability_flow: bool = False) -> "ReverseSDE":
    """Reverse-time SDE (or probability-flow ODE if ``probability_flow``)."""
    return ReverseSDE(self, score_fn, probability_flow)


class ReverseSDE:
  """Reverse-time SDE built from a forward SDE and a score function."""

  def __init__(self, fwd: SDE, score_fn: Callable, probability_flow: bool):
    self.fwd = fwd
    self.score_fn = score_fn
    self.probability_flow = bool(probability_flow)
    self.N = fwd.N

  @property
  def T(self) -> float:
    return self.fwd.T

  def sde(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
    drift, diffusion = self.fwd.sde(x, t)
    score = self.score_fn(x, t)
    scale = 0.5 if self.probability_flow else 1.0
    drift = drift - batch_mul(diffusion ** 2, score) * scale
    diffusion = (torch.zeros_like(diffusion) if self.probability_flow
                 else diffusion)
    return drift, diffusion

  def discretize(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor]:
    f, G = self.fwd.discretize(x, t)
    scale = 0.5 if self.probability_flow else 1.0
    rev_f = f - batch_mul(G ** 2, self.score_fn(x, t)) * scale
    rev_G = torch.zeros_like(G) if self.probability_flow else G
    return rev_f, rev_G


def _timestep(sde: SDE, t: Tensor) -> Tensor:
  """Discrete index of ``t`` on the N-point grid (truncated, as JAX int32)."""
  return (t * (sde.N - 1) / sde.T).long()


class VPSDE(SDE):
  """Variance-preserving SDE (DDPM)."""

  def __init__(self, beta_min: float = 0.1, beta_max: float = 20,
               N: int = 1000):
    super().__init__(N)
    self.beta_0 = float(beta_min)
    self.beta_1 = float(beta_max)
    betas = np.linspace(beta_min / N, beta_max / N, N, dtype=np.float64)
    self.discrete_betas = torch.tensor(betas, dtype=torch.float32)
    alphas = 1.0 - betas
    self.alphas = torch.tensor(alphas, dtype=torch.float32)
    # Clip for degenerate schedules (beta > 1 when N is tiny), as in JAX.
    ac = np.clip(np.cumprod(alphas), 0.0, 1.0)
    self.alphas_cumprod = torch.tensor(ac, dtype=torch.float32)
    self.sqrt_alphas_cumprod = torch.tensor(np.sqrt(ac), dtype=torch.float32)
    self.sqrt_1m_alphas_cumprod = torch.tensor(np.sqrt(1.0 - ac),
                                               dtype=torch.float32)

  @property
  def T(self) -> float:
    return 1.0

  def coefficient(self, t):
    beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
    return -0.5 * beta_t, torch.sqrt(beta_t)

  def sde(self, x, t):
    drift_coef, diffusion = self.coefficient(t)
    return batch_mul(drift_coef, x), diffusion

  def marginal_coef(self, t):
    log_mean_coeff = (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                      - 0.5 * t * self.beta_0)
    mean = torch.exp(log_mean_coeff)
    std = torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff))
    return mean, std

  def prior_sampling(self, shape, *, generator=None, device=None):
    return torch.randn(tuple(shape), generator=generator, device=device)

  def prior_logp(self, z):
    n = float(np.prod(z.shape[1:]))
    return -n / 2.0 * float(np.log(2 * np.pi)) - _sum_sq(z) / 2.0

  def discretize(self, x, t):
    """DDPM ancestral discretization."""
    timestep = _timestep(self, t)
    beta = self.discrete_betas.to(t.device)[timestep]
    alpha = self.alphas.to(t.device)[timestep]
    f = batch_mul(torch.sqrt(alpha), x) - x
    G = torch.sqrt(beta)
    return f, G


class subVPSDE(SDE):
  """Sub-VP SDE."""

  def __init__(self, beta_min: float = 0.1, beta_max: float = 20,
               N: int = 1000):
    super().__init__(N)
    self.beta_0 = float(beta_min)
    self.beta_1 = float(beta_max)
    alphas = 1.0 - np.linspace(beta_min / N, beta_max / N, N,
                               dtype=np.float64)
    self.alphas = torch.tensor(alphas, dtype=torch.float32)

  @property
  def T(self) -> float:
    return 1.0

  def coefficient(self, t):
    beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
    discount = 1.0 - torch.exp(-2 * self.beta_0 * t
                               - (self.beta_1 - self.beta_0) * t ** 2)
    return -0.5 * beta_t, torch.sqrt(beta_t * discount)

  def sde(self, x, t):
    drift_coef, diffusion = self.coefficient(t)
    return batch_mul(drift_coef, x), diffusion

  def marginal_coef(self, t):
    log_mean_coeff = (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                      - 0.5 * t * self.beta_0)
    mean = torch.exp(log_mean_coeff)
    # Sub-VP std is 1 - exp(2 * log_mean_coeff), not its sqrt.
    std = 1.0 - torch.exp(2.0 * log_mean_coeff)
    return mean, std

  def prior_sampling(self, shape, *, generator=None, device=None):
    return torch.randn(tuple(shape), generator=generator, device=device)

  def prior_logp(self, z):
    n = float(np.prod(z.shape[1:]))
    return -n / 2.0 * float(np.log(2 * np.pi)) - _sum_sq(z) / 2.0


class VESDE(SDE):
  """Variance-exploding SDE (SMLD)."""

  def __init__(self, sigma_min: float = 0.01, sigma_max: float = 50,
               N: int = 1000):
    super().__init__(N)
    self.sigma_min = float(sigma_min)
    self.sigma_max = float(sigma_max)
    self.discrete_sigmas = torch.tensor(
        np.exp(np.linspace(np.log(sigma_min), np.log(sigma_max), N)),
        dtype=torch.float32)

  @property
  def T(self) -> float:
    return 1.0

  def coefficient(self, t):
    sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
    drift_coef = torch.zeros_like(t)
    diffusion = sigma * float(np.sqrt(2 * (np.log(self.sigma_max)
                                           - np.log(self.sigma_min))))
    return drift_coef, diffusion

  def sde(self, x, t):
    drift_coef, diffusion = self.coefficient(t)
    return batch_mul(drift_coef, torch.ones_like(x)), diffusion

  def marginal_coef(self, t):
    std = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
    return torch.ones_like(t), std

  def marginal_prob(self, x, t):
    _, std = self.marginal_coef(t)
    return x, std

  def prior_sampling(self, shape, *, generator=None, device=None):
    return (torch.randn(tuple(shape), generator=generator, device=device)
            * self.sigma_max)

  def prior_logp(self, z):
    n = float(np.prod(z.shape[1:]))
    return (-n / 2.0 * float(np.log(2 * np.pi * self.sigma_max ** 2))
            - _sum_sq(z) / (2 * self.sigma_max ** 2))

  def discretize(self, x, t):
    """SMLD (NCSN) discretization."""
    timestep = _timestep(self, t)
    sigmas = self.discrete_sigmas.to(t.device)
    sigma = sigmas[timestep]
    adjacent_sigma = torch.where(timestep == 0, torch.zeros_like(t),
                                 sigmas[torch.clamp(timestep - 1, min=0)])
    f = torch.zeros_like(x)
    G = torch.sqrt(sigma ** 2 - adjacent_sigma ** 2)
    return f, G


def get_sde(config) -> Tuple[SDE, float]:
  """Build an SDE and its integration floor ``eps`` from a config."""
  name = config.training.sde.lower()
  if name == 'vpsde':
    sde = VPSDE(beta_min=config.model.beta_min,
                beta_max=config.model.beta_max, N=config.model.num_scales)
    eps = 1e-3
  elif name == 'subvpsde':
    sde = subVPSDE(beta_min=config.model.beta_min,
                   beta_max=config.model.beta_max, N=config.model.num_scales)
    eps = 1e-3
  elif name == 'vesde':
    sde = VESDE(sigma_min=config.model.sigma_min,
                sigma_max=config.model.sigma_max, N=config.model.num_scales)
    eps = 1e-5
  else:
    raise NotImplementedError(f"SDE {name} unknown.")
  return sde, eps
