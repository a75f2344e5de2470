"""Every norm of ``models/normalization.py`` and every block of
``models/layers_ncsn.py``, the port against the JAX package in f32 on the
CPU at tiny shapes (batch 2, 8x8 (7x7 for ``adjust_padding``), 6-8
channels, 5 classes): each flax module's parameters from ``jax.eval_shape``
of its init, randomised (the norms' scales near 1,
``port_parity.NCSN_SCALES``) and copied in by ``convert.params_from_jax``,
which refuses a leaf left over on either side.  All cases run in one
jitted JAX program (a module-scoped fixture), each a test of its own.
Limit: 1e-4 of max |JAX|."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu.models import layers_ncsn as j_layers
from b_pinn_kalman_filter_tpu.models import normalization as j_norms
from b_pinn_kalman_filter_tpu_torch.models import convert
from b_pinn_kalman_filter_tpu_torch.models import layers_ncsn as t_layers
from b_pinn_kalman_filter_tpu_torch.models import normalization as t_norms
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
B, C, K = 2, 8, 5
J_NORM = j_norms.InstanceNorm2dPlus
T_NORM = t_norms.InstanceNorm2dPlus
J_COND = functools.partial(j_norms.ConditionalInstanceNorm2dPlus,
                           num_classes=K)
T_COND = functools.partial(t_norms.ConditionalInstanceNorm2dPlus,
                           num_classes=K)


def _inputs():
  rng = np.random.default_rng(0)

  def image(size, channels, shift=0.0):
    return (rng.standard_normal((B, size, size, channels)) + shift).astype(
        np.float32)

  return dict(x=image(8, C, 0.3), x7=image(7, C), x32=image(8, 32, -0.2),
              x4=image(4, 6), y=np.array([1, 4], np.int32))


# name: (flax module, port module, names of the inputs, extra arguments).
# A norm's port takes its channels first; a block's port its input
# channels (a list for the multi-input blocks).
CASES = {
    'InstanceNorm2d': (j_norms.InstanceNorm2d(), t_norms.InstanceNorm2d(C),
                       ('x',), ()),
    'VarianceNorm2d': (j_norms.VarianceNorm2d(), t_norms.VarianceNorm2d(C),
                       ('x',), ()),
    'NoneNorm2d': (j_norms.NoneNorm2d(), t_norms.NoneNorm2d(C), ('x',), ()),
    'InstanceNorm2dPlus': (j_norms.InstanceNorm2dPlus(),
                           t_norms.InstanceNorm2dPlus(C), ('x',), ()),
    'InstanceNorm2dPlus_nobias': (
        j_norms.InstanceNorm2dPlus(bias=False),
        t_norms.InstanceNorm2dPlus(C, bias=False), ('x',), ()),
    'GroupNorm': (None, None, ('x32',), ()),
}
for _cls in ('ConditionalBatchNorm2d', 'ConditionalInstanceNorm2d',
             'ConditionalNoneNorm2d', 'ConditionalInstanceNorm2dPlus',
             'ConditionalVarianceNorm2d'):
  for _bias in (True, False):
    CASES[_cls + ('' if _bias else '_nobias')] = (
        getattr(j_norms, _cls)(num_classes=K, bias=_bias),
        getattr(t_norms, _cls)(C, num_classes=K, bias=_bias), ('x', 'y'), ())
CASES.update({
    'NCSNConv_stride2_nobias': (
        j_layers.NCSNConv(6, stride=2, bias=False),
        t_layers.NCSNConv(C, 6, stride=2, bias=False), ('x',), ()),
    'NCSNConv_dilation2': (j_layers.NCSNConv(6, dilation=2),
                           t_layers.NCSNConv(C, 6, dilation=2), ('x',), ()),
    'NCSNConv_5x5_stride2_dilation2': (
        j_layers.NCSNConv(6, kernel=5, stride=2, dilation=2),
        t_layers.NCSNConv(C, 6, kernel=5, stride=2, dilation=2), ('x7',),
        ()),
    'NCSNConv_1x1': (j_layers.NCSNConv(6, kernel=1),
                     t_layers.NCSNConv(C, 6, kernel=1), ('x',), ()),
    'interpolate_bilinear_up': (None, None, ('x4',), ((8, 11),)),
    'interpolate_bilinear_down': (None, None, ('x',), ((5, 3),)),
    'ConvMeanPool': (j_layers.ConvMeanPool(6),
                     t_layers.ConvMeanPool(C, 6), ('x',), ()),
    'ConvMeanPool_adjust': (
        j_layers.ConvMeanPool(6, adjust_padding=True),
        t_layers.ConvMeanPool(C, 6, adjust_padding=True), ('x7',), ()),
    'ConvMeanPool_1x1_nobias': (
        j_layers.ConvMeanPool(6, 1, biases=False),
        t_layers.ConvMeanPool(C, 6, 1, biases=False), ('x',), ()),
    'MeanPoolConv': (j_layers.MeanPoolConv(6), t_layers.MeanPoolConv(C, 6),
                     ('x',), ()),
    'UpsampleConv': (j_layers.UpsampleConv(6), t_layers.UpsampleConv(C, 6),
                     ('x',), ()),
    'CRPBlock_max': (j_layers.CRPBlock(C, 2, jax.nn.elu),
                     t_layers.CRPBlock(C, 2, F.elu), ('x',), ()),
    'CRPBlock_avg': (j_layers.CRPBlock(C, 3, maxpool=False),
                     t_layers.CRPBlock(C, 3, maxpool=False), ('x',), ()),
    'CondCRPBlock': (j_layers.CondCRPBlock(C, 2, J_COND, jax.nn.elu),
                     t_layers.CondCRPBlock(C, 2, T_COND, F.elu),
                     ('x', 'y'), ()),
    'RCUBlock': (j_layers.RCUBlock(C, 2, 2, jax.nn.elu),
                 t_layers.RCUBlock(C, 2, 2, F.elu), ('x',), ()),
    'CondRCUBlock': (j_layers.CondRCUBlock(C, 2, 2, J_COND),
                     t_layers.CondRCUBlock(C, 2, 2, T_COND), ('x', 'y'), ()),
    'MSFBlock': (j_layers.MSFBlock(5), t_layers.MSFBlock([C, 6], 5),
                 (('x', 'x4'),), ((8, 8),)),
    'CondMSFBlock': (j_layers.CondMSFBlock(5, J_COND),
                     t_layers.CondMSFBlock([C, 6], 5, T_COND),
                     (('x', 'x4'), 'y'), ((8, 8),)),
    'RefineBlock_start': (
        j_layers.RefineBlock(C, 1, jax.nn.elu, start=True),
        t_layers.RefineBlock([C], C, F.elu, start=True), (('x',),),
        ((8, 8),)),
    'RefineBlock_end_avg': (
        j_layers.RefineBlock(5, 2, jax.nn.elu, end=True, maxpool=False),
        t_layers.RefineBlock([C, 6], 5, F.elu, end=True, maxpool=False),
        (('x', 'x4'),), ((8, 8),)),
    'CondRefineBlock': (
        j_layers.CondRefineBlock(5, 2, J_COND, jax.nn.elu, end=True),
        t_layers.CondRefineBlock([C, 6], 5, T_COND, F.elu, end=True),
        (('x', 'x4'), 'y'), ((8, 8),)),
})
for _name, _kw in {'down': dict(resample='down'),
                   'down_dilated': dict(resample='down', dilation=2),
                   'down_adjust': dict(resample='down', adjust_padding=True),
                   'same': dict(out=C),
                   'widen': dict(),
                   'widen_dilated': dict(dilation=2)}.items():
  _kw = dict(_kw)
  _out = _kw.pop('out', 12)
  _x = 'x7' if 'adjust' in _name else 'x'
  CASES[f'ResidualBlock_{_name}'] = (
      j_layers.ResidualBlock(_out, J_NORM, act=jax.nn.elu, **_kw),
      t_layers.ResidualBlock(C, _out, T_NORM, act=F.elu, **_kw), (_x,), ())
  if _name in ('down', 'down_dilated', 'widen'):
    CASES[f'ConditionalResidualBlock_{_name}'] = (
        j_layers.ConditionalResidualBlock(_out, J_COND, act=jax.nn.elu,
                                          **_kw),
        t_layers.ConditionalResidualBlock(C, _out, T_COND, act=F.elu,
                                          **_kw), (_x, 'y'), ())


def _config(normalization):
  import types
  return types.SimpleNamespace(model=types.SimpleNamespace(
      normalization=normalization, num_classes=K))


def _modules(name):
  """(flax module or function, port module or function) of a case."""
  if name == 'GroupNorm':
    return (j_norms.get_normalization(_config('GroupNorm'))(),
            t_norms.get_normalization(_config('GroupNorm'))(32))
  if name.startswith('interpolate_bilinear'):
    return j_layers.interpolate_bilinear, t_layers.interpolate_bilinear
  return CASES[name][:2]


def _args(name, inputs, wrap):
  args = [[wrap(inputs[k]) for k in a] if isinstance(a, tuple)
          else wrap(inputs[a]) for a in CASES[name][2]]
  return args + list(CASES[name][3])


@pytest.fixture(scope='module')
def jax_side():
  """{case: (randomised params, JAX output)}: every case's init only
  shape-traced, then every forward in one jitted program."""
  inputs = _inputs()
  params = {}
  for i, name in enumerate(CASES):
    module, _ = _modules(name)
    if hasattr(module, 'init'):
      shapes = jax.eval_shape(lambda m=module, n=name: m.init(
          jax.random.PRNGKey(0), *_args(n, inputs, jnp.asarray)))
      params[name] = port_parity.randomized_params(
          shapes.get('params', {}), seed=i, scales=port_parity.NCSN_SCALES)

  def run(params, inputs):
    out = {}
    for name in CASES:
      module, _ = _modules(name)
      args = _args(name, inputs, lambda v: v)
      if name in params:
        out[name] = module.apply({'params': params[name]}, *args)
      else:
        out[name] = module(*args)
    return out

  outputs = jax.jit(run)(params, {k: jnp.asarray(v)
                                  for k, v in inputs.items()})
  return inputs, params, {k: np.asarray(v) for k, v in outputs.items()}


@pytest.mark.parametrize('name', list(CASES))
def test_block_matches_jax(name, jax_side):
  inputs, params, outputs = jax_side
  _, module = _modules(name)
  args = _args(name, inputs, torch.from_numpy)
  if isinstance(module, torch.nn.Module):
    convert.params_from_jax(params.get(name, {}), module)
  with torch.no_grad():
    got = module(*args).numpy()
  want = outputs[name]
  assert got.shape == want.shape and got.dtype == np.float32
  err = np.abs(got - want).max() / np.abs(want).max()
  assert err <= TOL, (name, err)
