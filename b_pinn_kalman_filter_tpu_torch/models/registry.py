"""Model registry and score-function adapters.

Counterpart of the JAX package's ``models/registry.py``.  A torch module
holds its own parameters, so ``get_model_fn`` and ``get_score_fn`` take the
model where the JAX functions take ``(model, params)``, and take
``params``, a ``{flax name: tensor}`` dict, only to run the module under
other parameters (the train state's or its EMA) through
``torch.func.functional_call``.  ``train`` is an explicit flag, as in JAX,
not the module's mode.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.core.sde import batch_mul
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import layers

_MODELS = {}


def register_model(cls=None, *, name: Optional[str] = None):
  """Decorator registering a model class under ``name``."""

  def _register(cls):
    local_name = cls.__name__ if name is None else name
    if local_name in _MODELS:
      raise ValueError(f'Already registered model with name: {local_name}')
    _MODELS[local_name] = cls
    return cls

  return _register if cls is None else _register(cls)


def get_model(name: str):
  return _MODELS[name]


def get_sigmas(config) -> np.ndarray:
  """Geometric noise levels for SMLD."""
  return np.exp(np.linspace(np.log(config.model.sigma_max),
                            np.log(config.model.sigma_min),
                            config.model.num_scales))


def create_model(config, *, device=None, seed: Optional[int] = None,
                 kernels: bool = True) -> nn.Module:
  """The configured score model on ``device`` (default ``cuda``), with
  parameters drawn by its own DDPM init from a CPU generator seeded with
  ``seed`` (default ``config.seed``), in eval mode."""
  device = get_device(device)
  model = get_model(config.model.name)(config, kernels=kernels)
  generator = torch.Generator().manual_seed(
      config.seed if seed is None else seed)
  layers.init_params(model, generator)
  return model.to(device).eval()


def get_model_fn(model: nn.Module, train: bool = False,
                 params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Callable:
  """``model_fn(x, labels, generator=None)``: the raw model in train or
  eval mode, under ``params`` when given; ``generator`` feeds dropout in
  train mode."""

  def model_fn(x, labels, generator=None):
    kwargs = dict(train=train, generator=generator)
    if params is None:
      return model(x, labels, **kwargs)
    return functional_call(model, params, (x, labels), kwargs)

  return model_fn


def get_score_fn(sde, model: nn.Module, train: bool = False,
                 continuous: bool = False,
                 params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Callable:
  """Adapt model output to a true score function
  ``score_fn(x, t, generator=None)``."""
  model_fn = get_model_fn(model, train=train, params=params)

  if isinstance(sde, (sde_lib.VPSDE, sde_lib.subVPSDE)):

    def score_fn(x, t, generator=None):
      if continuous or isinstance(sde, sde_lib.subVPSDE):
        # Continuous-time models assume a max time-embedding value of 999.
        labels = t * 999
        score = model_fn(x, labels, generator)
        std = sde.marginal_coef(t)[1]
      else:
        labels = t * (sde.N - 1)
        score = model_fn(x, labels, generator)
        std = sde.sqrt_1m_alphas_cumprod.to(t.device)[labels.long()]
      return batch_mul(-1.0 / std, score)

  elif isinstance(sde, sde_lib.VESDE):

    def score_fn(x, t, generator=None):
      if continuous:
        labels = sde.marginal_coef(t)[1]
      else:
        # For VE-trained models, t=0 corresponds to the highest noise level.
        labels = torch.round((sde.T - t) * (sde.N - 1)).long()
      return model_fn(x, labels, generator)

  else:
    raise NotImplementedError(
        f"SDE class {sde.__class__.__name__} not yet supported.")

  return score_fn
