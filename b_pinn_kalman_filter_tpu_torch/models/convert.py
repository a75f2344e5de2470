"""Load the JAX package's flax ``params`` into the port's modules.

The port's layers keep the flax names and layouts (conv ``kernel`` HWIO,
``Dense`` ``kernel`` (in, out), ``NIN`` ``W`` (in, out), GroupNorm
``scale``/``bias``), so each flax leaf at path ``a/b/c`` is the parameter
``a.b.c`` of the torch module, copied as it is.
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


@torch.no_grad()
def params_from_jax(tree: Mapping[str, Any], model: nn.Module) -> nn.Module:
  """Copy a flax ``params`` tree (nested dicts of arrays) into ``model``.

  Raises ``ValueError`` on a leaf that names no parameter, on a parameter
  that no leaf sets, and on a shape that differs.  Returns ``model``.
  """
  flat = _flatten(tree)
  params = dict(model.named_parameters())
  stray = sorted(set(flat) - set(params))
  missing = sorted(set(params) - set(flat))
  if stray:
    raise ValueError(f'flax leaves with no parameter in the model: {stray}')
  if missing:
    raise ValueError(f'model parameters that no flax leaf sets: {missing}')
  for name, p in params.items():
    value = np.asarray(flat[name], dtype=np.float32)
    if value.shape != tuple(p.shape):
      raise ValueError(f'{name}: flax shape {value.shape} '
                       f'!= model shape {tuple(p.shape)}')
    p.copy_(torch.from_numpy(value))
  return model
