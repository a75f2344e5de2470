"""Load the JAX package's flax ``params`` and train states into the port.

The port's layers keep the flax names and layouts (conv ``kernel`` HWIO,
``Dense`` ``kernel`` (in, out), ``NIN`` ``W`` (in, out), GroupNorm
``scale``/``bias``; the ``MLP``'s ``Dense_0``, ``Dense_1``, ...; the
LiteFlowNet's ``Features_0``/``Features_1``, each level's ``Matching_*``,
``Subpixel_*`` and ``Regularization_*``, and its grouped deconvolutions'
``weight`` (4, 4, 1, C); NCSN++'s FIR ``Conv2d_0`` ``weight`` HWIO and its
``GaussianFourierProjection_0`` ``W``, a leaf of the params, the Adam
moments and the EMA as in JAX; the NCSN models' ``NCSNConv_k.Conv_0``
``kernel`` (and ``bias`` where the conv has one), InstanceNorm++'s and the
variance norm's ``alpha``, ``gamma``, ``beta`` (C,), the conditional
norms' ``Embed_0.embedding`` (num_classes, k C) and the conditional
residual block's 1x1 ``Conv_0``), so each flax leaf at path ``a/b/c`` is
the parameter ``a.b.c`` of the torch module, copied as it is.  Every
function here raises ``ValueError`` on a leaf that names no parameter, on
a parameter that no leaf sets, and on a shape that differs.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from b_pinn_kalman_filter_tpu_torch.train.state import AdamState, TrainState


def _flatten(tree: Mapping[str, Any], prefix: str = '') -> Dict[str, Any]:
  """``{dotted path: leaf}``; a leaf without a shape (optax's
  ``MaskedNode``, where another group owns the subtree) is left out."""
  flat = {}
  for key, value in tree.items():
    path = f'{prefix}{key}'
    if isinstance(value, Mapping):
      flat.update(_flatten(value, path + '.'))
    elif hasattr(value, 'shape'):
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


def _adam_parts(opt_state):
  """The ``ScaleByAdamState`` (``mu``, ``nu``, ``count``) inside an optax
  chain's state, or ``{label: ScaleByAdamState}`` inside a
  ``multi_transform``'s (its ``inner_states``), found by their fields (the
  port imports no optax)."""
  inner = getattr(opt_state, 'inner_states', None)
  if isinstance(inner, Mapping):
    return {label: _adam_parts(s) for label, s in inner.items()}
  if all(hasattr(opt_state, k) for k in ('mu', 'nu', 'count')):
    return opt_state
  if isinstance(opt_state, (tuple, list)):
    found = [s for s in map(_adam_parts, opt_state) if s is not None]
    if len(found) > 1:
      raise ValueError('more than one Adam state in the optimizer state')
    return found[0] if found else None
  return None


def _adam_state(adam, params: Mapping[str, torch.Tensor], what: str
                ) -> AdamState:
  if adam is None:
    raise ValueError(f'{what}no Adam state (mu, nu, count) in the '
                     'optimizer state')
  return AdamState(count=int(np.asarray(adam.count)),
                   mu=_tensors_from_jax(adam.mu, params, f'{what}mu: '),
                   nu=_tensors_from_jax(adam.nu, params, f'{what}nu: '))


def _is_posterior(tree: Mapping[str, Any]) -> bool:
  """Whether a flax params tree is a B-PINN posterior ``{key: {'mu': ...,
  'rho': ...}}``."""
  return bool(tree) and all(isinstance(v, Mapping) and set(v) == {'mu', 'rho'}
                            for v in tree.values())


def _state_names(tree: Mapping[str, Any], model: nn.Module
                 ) -> Dict[str, torch.Tensor]:
  """The port's names for the leaves of a train state's ``params``, each
  with a tensor of its shape and device: ``model``'s parameters, or for a
  B-PINN posterior the flat posterior names (``pinn/bayes.py``
  ``flatten_posterior``) over the PINN sub-modules' parameters."""
  if not _is_posterior(tree):
    return dict(model.named_parameters())
  names = {}
  for key in tree:
    sub = dict(getattr(model, key).named_parameters())
    for part in ('mu', 'rho'):
      names.update({f'{key}.{part}.{n}': p for n, p in sub.items()})
  return names


def train_state_from_jax(jax_state, model: nn.Module) -> TrainState:
  """A JAX package ``TrainState`` (params, the optax Adam moments and
  count, the EMA, the step) as the port's ``train.state.TrainState`` over
  ``model``'s parameter names, on their devices.  A state whose params are
  a B-PINN posterior (``{key: {'mu', 'rho'}}`` over the PINN's
  sub-modules) takes the flat posterior names ``<key>.mu.<name>`` and
  ``<key>.rho.<name>``.  A ``multi_transform`` state becomes ``{label:
  AdamState}``, each over the names its group's moments hold (the others
  are optax's masked nodes); every parameter must fall in exactly one
  group."""
  params = _state_names(jax_state.params, model)
  adam = _adam_parts(jax_state.opt_state)
  if isinstance(adam, Mapping):
    opt_state = {}
    for label, part in adam.items():
      names = set(_flatten(part.mu)) if part is not None else set()
      opt_state[label] = _adam_state(
          part, {k: v for k, v in params.items() if k in names},
          f'{label}: ')
    counts = collections.Counter(k for s in opt_state.values() for k in s.mu)
    if set(counts) != set(params) or max(counts.values()) > 1:
      raise ValueError('the optimizer groups do not cover each parameter '
                       'exactly once')
  else:
    opt_state = _adam_state(adam, params, '')
  trees = {what: _tensors_from_jax(tree, params, f'{what}: ')
           for what, tree in (('params', jax_state.params),
                              ('ema_params', jax_state.ema_params))}
  return TrainState(step=int(np.asarray(jax_state.step)),
                    params={k: v.requires_grad_()
                            for k, v in trees['params'].items()},
                    opt_state=opt_state,
                    ema_params=trees['ema_params'],
                    ema_rate=float(jax_state.ema_rate))


def _unflatten(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  tree: Dict[str, Any] = {}
  for name, value in flat.items():
    *path, leaf = name.split('.')
    node = tree
    for key in path:
      node = node.setdefault(key, {})
    node[leaf] = value.detach().cpu().numpy().copy()   # not a view
  return tree


def train_state_to_jax(state) -> Dict[str, Any]:
  """A copy of the port's train state as the JAX package's trees of numpy
  arrays: ``{step, params, mu, nu, count, ema_params}``, each tree nested
  by the flax path; with optimizer groups ``mu``, ``nu`` and ``count`` are
  ``{label: ...}``."""
  opt = state.opt_state
  if isinstance(opt, AdamState):
    mu, nu, count = _unflatten(opt.mu), _unflatten(opt.nu), opt.count
  else:
    mu = {label: _unflatten(s.mu) for label, s in opt.items()}
    nu = {label: _unflatten(s.nu) for label, s in opt.items()}
    count = {label: s.count for label, s in opt.items()}
  return dict(step=state.step, params=_unflatten(state.params), mu=mu,
              nu=nu, count=count, ema_params=_unflatten(state.ema_params))


def random_proxy_from_jax(weights) -> tuple:
  """The JAX random-feature CNN's ``(w1, w2, w3, w4)`` (three HWIO 3x3
  kernels and the head, as ``jax.random.normal`` drew them under
  ``PRNGKey(2023)``) as the port's ``make_random_feature_fn(weights=)``
  takes them: float32 numpy, shapes checked."""
  ws = tuple(np.asarray(w, np.float32) for w in weights)
  if len(ws) != 4 or any(w.ndim != 4 or w.shape[:2] != (3, 3)
                         for w in ws[:3]) or ws[3].ndim != 2:
    raise ValueError('the random proxy takes three (3, 3, in, out) kernels '
                     'and an (in, out) head')
  for a, b in zip(ws, ws[1:]):
    if a.shape[-1] != b.shape[-2]:
      raise ValueError(f'widths {a.shape} -> {b.shape} do not chain')
  return ws


def inception_params_from_jax(params: Mapping[str, Any]) -> Dict[str, Any]:
  """The JAX package's InceptionV3 ``{name: (HWIO kernel, bias)}`` (BN
  folded; ``random_inception_params`` or a loaded file) as the port's
  ``train/inception.py`` takes them: float32 numpy, every conv of its
  ``CONV_SPEC`` and the fc present with its shape."""
  from b_pinn_kalman_filter_tpu_torch.train import inception
  want = {name: (k + (cin, cout), (cout,))
          for name, k, cin, cout, _, _ in inception.CONV_SPEC}
  want['fc'] = ((inception.FEATURE_DIM, inception.NUM_LOGITS),
                (inception.NUM_LOGITS,))
  if set(params) != set(want):
    raise ValueError(f'InceptionV3 names differ: '
                     f'{sorted(set(params) ^ set(want))[:5]}')
  out = {}
  for name, (w, b) in params.items():
    w, b = np.asarray(w, np.float32), np.asarray(b, np.float32)
    if (w.shape, b.shape) != want[name]:
      raise ValueError(f'{name}: shapes {w.shape}, {b.shape}, expected '
                       f'{want[name]}')
    out[name] = (w, b)
  return out
