"""Train state: parameters, the Adam state and the EMA of the parameters.

Counterpart of the JAX package's ``train/state.py``.  Each tree of flax
leaves is a ``{flax name: float32 tensor}`` dict (the names of the
module's ``named_parameters()``), so a step runs the model under it with
``torch.func.functional_call``.  Where the JAX step returns a new state
(and donates the old one), the port's step updates the tensors of this
one in place, which saves a copy of every tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
  """optax ``ScaleByAdamState``: the update count and the two moments."""
  count: int
  mu: Params
  nu: Params


@dataclasses.dataclass
class TrainState:
  step: int
  params: Params
  opt_state: Union[AdamState, Dict[str, AdamState]]
  ema_params: Params
  ema_rate: float = 0.999


def ema_decay(step: int, rate: float) -> float:
  """min(rate, (1 + n) / (10 + n)) at the step *before* its increment,
  in float32 as the JAX package computes it."""
  n = np.float32(step)
  return float(np.minimum(np.float32(rate),
                          (np.float32(1.0) + n) / (np.float32(10.0) + n)))


@torch.no_grad()
def ema_update_(state: TrainState, new_params: Params) -> None:
  """One EMA step, ``e - (1 - decay) * (e - p)``, into ``state.ema_params``
  (decay from ``state.step``, not yet incremented)."""
  one_minus = float(np.float32(1.0)
                    - np.float32(ema_decay(state.step, state.ema_rate)))
  ema = list(state.ema_params.values())
  diff = torch._foreach_sub(ema, [new_params[k] for k in state.ema_params])
  torch._foreach_mul_(diff, one_minus)
  torch._foreach_sub_(ema, diff)


def create_train_state(params: Params, tx, ema_rate: float) -> TrainState:
  """Step 0: ``params`` (each made to require grad, and trained in place),
  ``tx.init(params)``, and the EMA a copy of ``params``."""
  params = {k: v.requires_grad_() for k, v in params.items()}
  return TrainState(
      step=0, params=params, opt_state=tx.init(params),
      ema_params={k: v.detach().clone() for k, v in params.items()},
      ema_rate=float(ema_rate))
