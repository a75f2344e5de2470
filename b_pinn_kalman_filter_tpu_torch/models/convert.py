"""Load the JAX package's flax ``params`` into the port's modules.

The port's layers keep the flax names and layouts (conv ``kernel`` HWIO,
``Dense`` ``kernel`` (in, out), ``NIN`` ``W`` (in, out), GroupNorm
``scale``/``bias``), so each flax leaf at path ``a/b/c`` is the parameter
``a.b.c`` of the torch module, copied as it is.  Every function here
raises ``ValueError`` on a leaf that names no parameter, on a parameter
that no leaf sets, and on a shape that differs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping[str, Any], prefix: str = '') -> Dict[str, Any]:
  flat = {}
  for key, value in tree.items():
    path = f'{prefix}{key}'
    if isinstance(value, Mapping):
      flat.update(_flatten(value, path + '.'))
    else:
      flat[path] = value
  return flat


def _tensors_from_jax(tree: Mapping[str, Any],
                      params: Mapping[str, torch.Tensor], what: str = ''
                      ) -> Dict[str, torch.Tensor]:
  """``{name: float32 tensor}`` for each parameter in ``params``, from the
  leaves of ``tree``, on the parameters' devices."""
  flat = _flatten(tree)
  stray = sorted(set(flat) - set(params))
  missing = sorted(set(params) - set(flat))
  if stray:
    raise ValueError(f'{what}flax leaves with no parameter in the model: '
                     f'{stray}')
  if missing:
    raise ValueError(f'{what}model parameters that no flax leaf sets: '
                     f'{missing}')
  out = {}
  for name, p in params.items():
    value = np.array(flat[name], dtype=np.float32)
    if value.shape != tuple(p.shape):
      raise ValueError(f'{what}{name}: flax shape {value.shape} '
                       f'!= model shape {tuple(p.shape)}')
    out[name] = torch.from_numpy(value).to(p.device)
  return out


@torch.no_grad()
def params_from_jax(tree: Mapping[str, Any], model: nn.Module) -> nn.Module:
  """Copy a flax ``params`` tree (nested dicts of arrays) into ``model``,
  e.g. the PINN's ``{'flownet': ..., 'pressurenet': ...}``.  Returns
  ``model``."""
  params = dict(model.named_parameters())
  for name, value in _tensors_from_jax(tree, params).items():
    params[name].copy_(value)
  return model


def draw_from_jax(tree: Mapping[str, Any], model: nn.Module
                  ) -> Dict[str, torch.Tensor]:
  """A flax params tree as a flat ``{name: tensor}`` dict of ``model``'s
  parameters (for ``torch.func.functional_call``), without touching the
  model: a B-PINN posterior draw of the JAX package."""
  return _tensors_from_jax(tree, dict(model.named_parameters()))


def bpinn_params_from_jax(tree: Mapping[str, Any], model: nn.Module) -> dict:
  """The JAX B-PINN posterior ``{key: {'mu': tree, 'rho': tree}}`` as the
  port's ``{key: {'mu': {name: tensor}, 'rho': {...}}}``, each name a
  parameter of the sub-module ``model.<key>`` of the PINN."""
  keys = ('flownet', 'pressurenet')
  if sorted(tree) != sorted(keys):
    raise ValueError(f'B-PINN tree keys {sorted(tree)} are not {list(keys)}')
  out = {}
  for key in keys:
    if sorted(tree[key]) != ['mu', 'rho']:
      raise ValueError(f'{key}: parts {sorted(tree[key])} are not mu, rho')
    params = dict(getattr(model, key).named_parameters())
    out[key] = {part: _tensors_from_jax(tree[key][part], params,
                                        f'{key}.{part}: ')
                for part in ('mu', 'rho')}
  return out
