"""PINN phase 1, the preliminary step: the port's ``pinn/losses.py``
against the JAX package's on the same randomised state, mask, injected
noise and batch (f32, CPU, ``feature_nums`` (8, 16), 16x16, batch 2); its
two-group optimizer against optax's ``multi_transform``; the flow and
pressure losses; and the two-group train state across the converters.

Limits, relative to max |JAX| over each tree (``tests/port_parity.py``):
1e-4 for the losses, the parameters, both groups' Adam moments, the EMA
and the optimizer's updates."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from b_pinn_kalman_filter_tpu.core import losses as jax_core_losses
from b_pinn_kalman_filter_tpu.models import flownet as jax_flownet
from b_pinn_kalman_filter_tpu.pinn import losses as jax_losses
from b_pinn_kalman_filter_tpu.train import state as jax_state
from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.models import convert, flownet
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train.state import (AdamState, TrainState,
                                                        create_train_state)
from tests import port_parity
from tests.port_parity import compare_trees
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
BATCH, SIZE = 2, 16
# Warmup 2: the steps take lr 0 and lr / 2, so that the second step moves
# every parameter; the PressureNet's lr x 0.001, as phase 1 sets it.
PRELIM = {('data', 'image_size'): SIZE,
          ('model', 'feature_nums'): (8, 16),
          ('training', 'batch_size'): BATCH,
          ('optim', 'warmup'): 2}
LR_MUL_PRES = 0.001


def _configs():
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  out = []
  for mod in (jax_configs, torch_configs):
    config = mod.get_config('pinn/pinn_pde')
    for (block, key), value in PRELIM.items():
      setattr(getattr(config, block), key, value)
    out.append(config)
  return tuple(out)


def _batch(seed):
  """(f1, f2, x, y, t, target) numpy float32 and a (H, W, 1) mask."""
  f1, f2, x, y, t = port_parity.pinn_inputs(BATCH, SIZE, seed)
  rng = np.random.default_rng(seed + 100)
  target = (0.5 * rng.standard_normal((BATCH, SIZE, SIZE, 3))).astype(
      np.float32)
  mask = (rng.random((SIZE, SIZE, 1)) < 0.7).astype(np.float32)
  return (f1, f2, x, y, t, target), mask


def _noise(rng, batch):
  """The two frames' standard normal draws the JAX step takes from
  ``rng`` (``r1, r2, _ = split(rng, 3)``), as tensors."""
  r1, r2, _ = jax.random.split(rng, 3)
  return tuple(torch.from_numpy(np.array(jax.random.normal(r, f.shape)))
               for r, f in zip((r1, r2), batch[:2]))


def _unmasked(tree):
  """An optax moment tree without the masked nodes of the other group."""
  out = {}
  for key, value in tree.items():
    if hasattr(value, 'items'):
      out[key] = _unmasked(value)
    elif hasattr(value, 'shape'):
      out[key] = value
  return {k: v for k, v in out.items() if not isinstance(v, dict) or v}


def _adam(opt_state, label):
  """The Adam state of group ``label`` in a ``multi_transform`` state."""
  inner = opt_state.inner_states[label]
  return convert._adam_parts(inner)


@pytest.fixture(scope='module')
def side():
  """The JAX side: configs, model, randomised params, the optimizer and
  the jitted train and eval steps (each compiled once)."""
  from b_pinn_kalman_filter_tpu.pinn.pinn import PINN as JaxPINN
  jax_config, torch_config = _configs()
  model = JaxPINN(jax_config)
  params = port_parity.randomized_params(
      port_parity.pinn_param_shapes(jax_config), seed=4)
  tx = jax_losses.get_pinn_optimizer(jax_config, lr_mul_pres=LR_MUL_PRES)
  jit = dict(compiler_options=port_parity.FAST_COMPILE)
  return types.SimpleNamespace(
      jax_config=jax_config, torch_config=torch_config, params=params,
      tx=tx,
      step=jax.jit(jax_losses.get_prelim_step_fn(jax_config, model, tx,
                                                 train=True), **jit),
      eval_step=jax.jit(jax_losses.get_prelim_step_fn(jax_config, model, tx,
                                                      train=False), **jit))


def _jax_state(side):
  return jax_state.create_train_state(
      jax.tree_util.tree_map(jnp.asarray, side.params), side.tx,
      side.jax_config.model.ema_rate)


def test_two_prelim_steps_and_an_eval_step_match_jax(side):
  config = side.torch_config
  model = PINN(config).eval()
  j_state = _jax_state(side)
  state = convert.train_state_from_jax(j_state, model)
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=LR_MUL_PRES)
  step_fn = pinn_losses.get_prelim_step_fn(config, model, tx, train=True)
  assert set(state.opt_state) == {'flow', 'pres'}

  for step in range(2):
    batch, mask = _batch(step)
    rng = jax.random.PRNGKey(step)
    j_state, j_losses = side.step(rng, j_state, jnp.asarray(mask),
                                  tuple(map(jnp.asarray, batch)))
    state, p_losses = step_fn(state, torch.from_numpy(mask),
                              tuple(map(torch.from_numpy, batch)),
                              noise=_noise(rng, batch))
    for got, want in zip(p_losses, j_losses):
      assert port_parity._rel(got.numpy(), want) <= TOL
    got = convert.train_state_to_jax(state)
    assert got['step'] == int(j_state.step) == step + 1
    compare_trees(got['params'], j_state.params, TOL, f'params {step}')
    compare_trees(got['ema_params'], j_state.ema_params, TOL, f'ema {step}')
    for label in ('flow', 'pres'):
      adam = _adam(j_state.opt_state, label)
      assert got['count'][label] == int(adam.count) == step + 1
      compare_trees(got['mu'][label], _unmasked(adam.mu), TOL,
                    f'mu {label} {step}')
      compare_trees(got['nu'][label], _unmasked(adam.nu), TOL,
                    f'nu {label} {step}')

  batch, mask = _batch(7)
  rng = jax.random.PRNGKey(7)
  _, j_eval = side.eval_step(rng, j_state, jnp.asarray(mask),
                             tuple(map(jnp.asarray, batch)))
  eval_fn = pinn_losses.get_prelim_step_fn(config, model, tx, train=False)
  _, p_eval = eval_fn(state, torch.from_numpy(mask),
                      tuple(map(torch.from_numpy, batch)),
                      noise=_noise(rng, batch))
  for got, want in zip(p_eval, j_eval):
    assert port_parity._rel(got.numpy(), want) <= TOL
  assert state.step == 2


def test_each_loss_reaches_only_its_own_network(side):
  """The pressure net reads the ground-truth flows: the flow loss's
  gradient is zero on every PressureNet leaf and the pressure loss's on
  every FlowNet leaf."""
  config = side.torch_config
  model = PINN(config).eval()
  state = convert.train_state_from_jax(_jax_state(side), model)
  batch, mask = _batch(3)
  f1, f2, x, y, t, target = map(torch.from_numpy, batch)
  veloc = model.flow_only(f1, f2, x, y, t, params=state.params)
  v_loss = flownet.multiscale_data_mse(veloc, target)
  p_loss = flownet.pressure_data_mse(model.pressure_only(
      pinn_losses.gt_flow_pyramid(config, target), x, y, t,
      params=state.params), target)
  names = list(state.params)
  for loss, own in ((v_loss, 'flow'), (p_loss, 'pres')):
    grads = torch.autograd.grad(loss, list(state.params.values()),
                                allow_unused=True)
    for name, g in zip(names, grads):
      mine = pinn_losses.pinn_label(name) == own
      assert (g is not None and bool(g.abs().max() > 0)) == mine, name


def test_pinn_optimizer_matches_optax_multi_transform(side):
  """Three updates of a two-group tree from equal gradients: the 'flow'
  group's gradient norm above the clip of 1, the 'pres' group's below it,
  so each group is clipped by its own norm alone (optax: (3, 4) and
  (0.3, 0.4) under clip 1 give (0.6, 0.8) and (0.3, 0.4))."""
  j_tx = jax_losses.get_pinn_optimizer(side.jax_config, lr_mul_pres=0.5)
  tx = pinn_losses.get_pinn_optimizer(side.torch_config, lr_mul_pres=0.5)
  rng = np.random.default_rng(5)
  shapes = {'flownet': {'a': (3, 4), 'b': (7,)},
            'pressurenet': {'c': (2, 5)}}
  params = {k: {n: (1e-3 * rng.standard_normal(s)).astype(np.float32)
                for n, s in v.items()} for k, v in shapes.items()}
  flat = dict(port_parity.leaves(params))
  j_params = jax.tree_util.tree_map(jnp.asarray, params)
  j_opt = j_tx.init(j_params)
  j_update = jax.jit(j_tx.update)
  p_params = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
  p_opt = tx.init(p_params)
  for step in range(3):
    scale = {'flownet': 3.0, 'pressurenet': 0.03}
    grads = {k: {n: (scale[k] * rng.standard_normal(s)).astype(np.float32)
                 for n, s in v.items()} for k, v in shapes.items()}
    norms = {k: np.sqrt(sum(np.sum(g ** 2) for g in v.values()))
             for k, v in grads.items()}
    assert norms['flownet'] > 1 > norms['pressurenet']
    updates, j_opt = j_update(jax.tree_util.tree_map(jnp.asarray, grads),
                              j_opt, j_params)
    before = {k: v.clone() for k, v in p_params.items()}
    flat_g = dict(port_parity.leaves(grads))
    tx.apply_([torch.from_numpy(flat_g[k]) for k in p_params], p_opt,
              p_params)
    j_params = optax.apply_updates(j_params, updates)
    if step:
      compare_trees(convert._unflatten({k: p_params[k] - before[k]
                                        for k in p_params}),
                    updates, TOL, f'update {step}')
    compare_trees(convert._unflatten(p_params), j_params, TOL,
                  f'params {step}')
    for label in ('flow', 'pres'):
      adam = _adam(j_opt, label)
      assert p_opt[label].count == int(adam.count) == step + 1
      compare_trees(convert._unflatten(p_opt[label].mu), _unmasked(adam.mu),
                    TOL, f'mu {label} {step}')
  # optax itself: gradients (3, 4) and (0.3, 0.4) under clip 1, one group each.
  clip = optax.multi_transform(
      {'flow': optax.clip_by_global_norm(1.0),
       'pres': optax.clip_by_global_norm(1.0)},
      lambda p: {k: 'pres' if k == 'pressurenet' else 'flow' for k in p})
  g = {'flownet': jnp.asarray([3.0, 4.0]),
       'pressurenet': jnp.asarray([0.3, 0.4])}
  out, _ = clip.update(g, clip.init(g))
  np.testing.assert_allclose(out['flownet'], [0.6, 0.8], rtol=1e-6)
  np.testing.assert_allclose(out['pressurenet'], [0.3, 0.4], rtol=1e-6)


@pytest.mark.parametrize('kwargs', [{}, {'lr_mul': 0.25},
                                    {'is_bpinn': True, 'lr_mul': 2.0}])
def test_get_optimizer_options_match_jax(kwargs):
  """``lr_mul`` scales the learning rate; ``is_bpinn`` takes ``bpinn_lr``
  and ``bpinn_weight_decay``."""
  jax_config, torch_config = _configs()
  torch_config.optim.bpinn_weight_decay = 0.01
  # (ml_collections keeps ``bpinn_weight_decay`` an int.)
  optim = types.SimpleNamespace(**dict(jax_config.optim.to_dict(),
                                       bpinn_weight_decay=0.01))
  jax_config = types.SimpleNamespace(optim=optim)
  tx = losses.get_optimizer(torch_config, **kwargs)
  lr, decay = ((optim.bpinn_lr, optim.bpinn_weight_decay)
               if kwargs.get('is_bpinn') else (optim.lr, optim.weight_decay))
  assert tx.lr == lr * kwargs.get('lr_mul', 1.0)
  assert tx.weight_decay == decay
  j_tx = jax_core_losses.get_optimizer(jax_config, **kwargs)
  rng = np.random.default_rng(6)
  p = {'w': (1e-3 * rng.standard_normal((4, 3))).astype(np.float32)}
  j_p, p_p = {'w': jnp.asarray(p['w'])}, {'w': torch.from_numpy(p['w'])}
  j_opt, p_opt = j_tx.init(j_p), tx.init(p_p)
  for _ in range(3):
    g = {'w': rng.standard_normal((4, 3)).astype(np.float32)}
    updates, j_opt = j_tx.update({'w': jnp.asarray(g['w'])}, j_opt, j_p)
    j_p = optax.apply_updates(j_p, updates)
    tx.apply_([torch.from_numpy(g['w'])], p_opt, p_p)
  compare_trees({'w': p_p['w'].numpy()}, j_p, TOL, 'params')


def test_flow_losses_and_pyramid_match_jax(side):
  """``multiscale_data_mse`` over a cascade of three flows (the JAX
  order: weights from the finest, 1/2**i, the target halved after each
  term), ``pressure_data_mse`` and the ground-truth pyramid."""
  rng = np.random.default_rng(8)
  target = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
  flows = [rng.standard_normal((BATCH, SIZE >> i, SIZE >> i, 2)).astype(
      np.float32) for i in (2, 1, 0)]
  pressure = rng.standard_normal((BATCH, SIZE, SIZE, 1)).astype(np.float32)
  t_target = torch.from_numpy(target)
  got = flownet.multiscale_data_mse([torch.from_numpy(f) for f in flows],
                                    t_target)
  want = jax_flownet.multiscale_data_mse([jnp.asarray(f) for f in flows],
                                         jnp.asarray(target))
  assert port_parity._rel(got.numpy(), want) <= TOL
  got = flownet.pressure_data_mse(torch.from_numpy(pressure), t_target)
  want = jax_flownet.pressure_data_mse(jnp.asarray(pressure),
                                       jnp.asarray(target))
  assert port_parity._rel(got.numpy(), want) <= TOL
  got = pinn_losses.gt_flow_pyramid(side.torch_config, t_target)
  want = jax_losses._gt_flow_pyramid(side.jax_config, jnp.asarray(target))
  assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
      (BATCH, 4, 4, 2), (BATCH, 8, 8, 2), (BATCH, 16, 16, 2)]
  for g, w in zip(got, want):
    assert port_parity._rel(g.numpy(), w) <= TOL


def test_two_group_state_round_trips(side, tmp_path):
  """JAX state -> port -> JAX trees keeps every leaf, both groups'
  moments and counts; a checkpoint of the two-group state restores into
  a fresh state; a single-group template refuses it."""
  config = side.torch_config
  model = PINN(config).eval()
  j_state = _jax_state(side)
  batch, mask = _batch(1)
  j_state, _ = side.step(jax.random.PRNGKey(1), j_state, jnp.asarray(mask),
                         tuple(map(jnp.asarray, batch)))
  state = convert.train_state_from_jax(j_state, model)
  got = convert.train_state_to_jax(state)
  compare_trees(got['params'], j_state.params, 0.0, 'params')
  for label in ('flow', 'pres'):
    adam = _adam(j_state.opt_state, label)
    compare_trees(got['mu'][label], _unmasked(adam.mu), 0.0, 'mu')
    compare_trees(got['nu'][label], _unmasked(adam.nu), 0.0, 'nu')
    assert got['count'][label] == int(adam.count) == 1
  assert set(got['mu']['pres']) == {'pressurenet'}
  assert set(got['mu']['flow']) == {'flownet'}

  path = str(tmp_path / 'checkpoint')
  ckpt_lib.save_checkpoint(path, state)
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=LR_MUL_PRES)
  fresh = create_train_state(
      {k: v.detach().clone() for k, v in model.named_parameters()}, tx,
      config.model.ema_rate)
  restored = ckpt_lib.restore_checkpoint(path, fresh)
  back = convert.train_state_to_jax(restored)
  assert back['step'] == 1 and back['count'] == {'flow': 1, 'pres': 1}
  for key in ('params', 'ema_params'):
    compare_trees(back[key], got[key], 0.0, key)
  for key in ('mu', 'nu'):
    for label in ('flow', 'pres'):
      compare_trees(back[key][label], got[key][label], 0.0, key)
  single = TrainState(step=0, params=fresh.params,
                      opt_state=AdamState(0, dict(fresh.params),
                                          dict(fresh.params)),
                      ema_params=fresh.ema_params)
  with pytest.raises(ValueError, match='optimizer groups'):
    ckpt_lib.restore_checkpoint(path, single)
