"""Standalone EMA helper with the reference's API.

Counterpart of the JAX package's ``models/ema.py``
``ExponentialMovingAverage``.  The train loop keeps its EMA inside the
train state (``train/state.py``), whose decay reads the step *before* its
increment; this class, like the JAX one, counts the update first:
decay = min(decay, (1 + n) / (10 + n)) with n already incremented.
Parameters are ``{name: tensor}`` dicts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def _copy(params: Params) -> Params:
  return {k: v.detach().clone() for k, v in params.items()}


class ExponentialMovingAverage:
  """Keeps an EMA of a parameter dict (reference ``models/ema.py``)."""

  def __init__(self, params: Params, decay: float,
               use_num_updates: bool = True):
    if decay < 0.0 or decay > 1.0:
      raise ValueError('Decay must be between 0 and 1')
    self.decay = decay
    self.num_updates = 0 if use_num_updates else None
    self.shadow_params = _copy(params)
    self.collected_params: Optional[Params] = None

  @torch.no_grad()
  def update(self, params: Params) -> None:
    """One EMA step with the warmup-aware decay."""
    decay = self.decay
    if self.num_updates is not None:
      self.num_updates += 1
      decay = min(decay, (1 + self.num_updates) / (10 + self.num_updates))
    one_minus = 1.0 - decay
    self.shadow_params = {
        k: s - one_minus * (s - params[k].detach())
        for k, s in self.shadow_params.items()}

  def copy_to(self, params: Params) -> Params:
    """The EMA parameters (functional, as the JAX helper)."""
    del params
    return self.shadow_params

  def store(self, params: Params) -> None:
    self.collected_params = _copy(params)

  def restore(self, params: Params) -> Params:
    del params
    return self.collected_params

  def state_dict(self):
    return dict(decay=self.decay, num_updates=self.num_updates,
                shadow_params=self.shadow_params)

  def load_state_dict(self, state_dict) -> None:
    self.decay = state_dict['decay']
    self.num_updates = state_dict['num_updates']
    self.shadow_params = state_dict['shadow_params']
