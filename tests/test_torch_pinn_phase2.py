"""PINN phase 2 on the CPU at tiny widths (one FlowNet level (4,), 8x8,
batch 2): the NaN gate of the step, the eval step under the EMA, and
``pinn_lib.train``, both phases with every event, phase 2's fresh
optimizer and a resume from ``checkpoint_pinn``.

The one ``slow`` test holds two phase-2 steps against the JAX package's
``get_pinn_step_fn`` (its jit of the third-order step takes one to two
minutes to compile on a CPU, too long for the tier-1 run, which
deselects ``slow``):

    JAX_PLATFORMS=cpu python -m pytest -q -m slow tests/test_torch_pinn_phase2.py

Limits, relative to max |JAX| over each tree (tests/port_parity.py): 1e-4
for the losses, the parameters, both groups' Adam moments and the EMA."""

import logging
import os

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn import pinn_lib
from b_pinn_kalman_filter_tpu_torch.train.state import create_train_state
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
BATCH, SIZE = 2, 8
TINY = {('data', 'image_size'): SIZE,
        ('model', 'feature_nums'): (4,),
        ('training', 'batch_size'): BATCH,
        ('optim', 'warmup'): 2}


def _config(**training):
  config = configs.get_config('pinn/pinn_pde')
  for (block, key), value in TINY.items():
    setattr(getattr(config, block), key, value)
  config.training.update(training)
  return config


def _batch(seed):
  """(f1, f2, x, y, t, target) numpy float32 on the jittered unit grid,
  and a (H, W, 1) mask."""
  f1, f2, x, y, t = port_parity.pinn_inputs(BATCH, SIZE, seed)
  rng = np.random.default_rng(seed + 100)
  x, y = ((c + 0.01 * rng.random(c.shape)).astype(np.float32)
          for c in (x, y))
  target = (0.5 * rng.standard_normal((BATCH, SIZE, SIZE, 3))).astype(
      np.float32)
  mask = (rng.random((SIZE, SIZE, 1)) < 0.7).astype(np.float32)
  return (f1, f2, x, y, t, target), mask


def _tensors(state):
  """Every tensor of a two-group train state, by name."""
  out = {f'params.{k}': v for k, v in state.params.items()}
  out.update({f'ema.{k}': v for k, v in state.ema_params.items()})
  for label, adam in state.opt_state.items():
    out.update({f'mu.{label}.{k}': v for k, v in adam.mu.items()})
    out.update({f'nu.{label}.{k}': v for k, v in adam.nu.items()})
  return out


def _copy(state):
  return ({k: v.detach().clone() for k, v in _tensors(state).items()},
          state.step, {k: s.count for k, s in state.opt_state.items()})


def _unchanged(state, copy):
  tensors, step, counts = copy
  now = _tensors(state)
  assert now.keys() == tensors.keys()
  assert all(torch.equal(now[k], v) for k, v in tensors.items())
  assert state.step == step
  assert {k: s.count for k, s in state.opt_state.items()} == counts


@pytest.fixture(scope='module')
def stepped():
  """The tiny PINN's train state after two phase-2 steps (warmup 2, so the
  second moves the parameters and the EMA leaves them), and its parts;
  the tests that share it leave the state as it is (they check so)."""
  config = _config()
  model, _ = pinn_lib.init_pinn(config, device='cpu')
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.005)
  state = create_train_state(dict(model.named_parameters()), tx,
                             config.model.ema_rate)
  step_fn = pinn_losses.get_pinn_step_fn(config, model, tx, train=True)
  generator = torch.Generator().manual_seed(0)
  for seed in range(2):
    batch, mask = _batch(seed)
    state, losses = step_fn(state, torch.from_numpy(mask),
                            tuple(map(torch.from_numpy, batch)), generator)
    assert all(bool(torch.isfinite(v)) for v in losses)
  assert state.step == 2
  return config, model, tx, state, step_fn


def test_nan_gate_leaves_the_state_bit_identical(stepped):
  """A batch with a NaN in a frame: every gradient is NaN, and nothing
  of the state changes (parameters, EMA, both groups' moments and counts,
  the step); the losses are still returned."""
  _, _, _, state, step_fn = stepped
  batch, mask = _batch(5)
  batch[0][1, 2, 3, 0] = np.nan
  copy = _copy(state)
  state, losses = step_fn(state, torch.from_numpy(mask),
                          tuple(map(torch.from_numpy, batch)),
                          noise=(torch.zeros(BATCH, SIZE, SIZE, 1),) * 2)
  assert len(losses) == 3 and not bool(torch.isfinite(losses[0]))
  _unchanged(state, copy)
  assert pinn_losses.all_finite([torch.ones(3), torch.zeros(2, 2)])
  for bad in (np.nan, np.inf, -np.inf):
    assert not pinn_losses.all_finite([torch.ones(3),
                                       torch.tensor([[0.0, bad]])])


def test_eval_step_is_the_loss_under_the_ema(stepped):
  """The eval losses are the loss under ``ema_params`` (not under the
  parameters, which differ), none keeps a graph, the state is unchanged
  and no parameter has a ``.grad``."""
  config, model, tx, state, _ = stepped
  eval_fn = pinn_losses.get_pinn_step_fn(config, model, tx, train=False)
  loss_fn = pinn_losses.get_pinn_loss_fn(config, model)
  batch, mask = _batch(6)
  batch, mask = tuple(map(torch.from_numpy, batch)), torch.from_numpy(mask)
  noise = tuple(torch.randn((BATCH, SIZE, SIZE, 1),
                            generator=torch.Generator().manual_seed(s))
                for s in (1, 2))
  copy = _copy(state)
  _, got = eval_fn(state, mask, batch, noise=noise)
  want = loss_fn(state.ema_params, mask, batch, noise=noise)
  under_params = loss_fn(state.params, mask, batch, noise=noise)
  for g, w in zip(got, want):
    assert not g.requires_grad
    torch.testing.assert_close(g, w.detach(), rtol=1e-6, atol=0)
  assert abs(float(got[0]) - float(under_params[0].detach())) > 1e-6
  _unchanged(state, copy)
  assert all(p.grad is None for p in list(_tensors(state).values())
             + list(model.parameters()))


def _train_config(n_pinn_iters):
  return _config(n_iters=3, n_pinn_iters=n_pinn_iters, log_freq=2,
                 eval_freq=3, snapshot_freq_for_preemption=2,
                 snapshot_freq=5)


def test_train_runs_both_phases_and_resumes_from_checkpoint_pinn(
    tmp_path, monkeypatch, caplog):
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  optimizers = []
  make = pinn_losses.get_pinn_optimizer

  def spy(config, lr_mul_pres=1.0, **kwargs):
    optimizers.append(lr_mul_pres)
    return make(config, lr_mul_pres=lr_mul_pres, **kwargs)

  monkeypatch.setattr(pinn_losses, 'get_pinn_optimizer', spy)
  workdir = str(tmp_path / 'work')
  history = []
  with caplog.at_level(logging.INFO, logger=pinn_lib.__name__):
    state = pinn_lib.train(_train_config(4), workdir, device='cpu',
                           history=history)
  # Step n_iters = 3 runs once in each phase.
  assert [(h['phase'], h['step']) for h in history] == (
      [('prelim', s) for s in range(4)] + [('pinn', s) for s in range(3, 8)])
  assert [h['events'] for h in history] == [
      ['log', 'eval'], [], ['log', 'preempt_ckpt'], ['eval', 'snapshot'],
      ['eval'], ['log', 'preempt_ckpt'], ['snapshot'],
      ['log', 'eval', 'preempt_ckpt'], ['snapshot']]
  assert all(np.isfinite(h['loss']) for h in history)
  assert optimizers == [0.001, 0.005]
  messages = [r.getMessage() for r in caplog.records]
  assert sum('step: ' in m and ' pinn_loss' in m for m in messages) == 2
  assert sum('eval_pinn_loss' in m for m in messages) == 2
  # Phase 2's Adam counts start afresh; its step goes on from n_iters.
  assert state.step == 8
  assert {k: s.count for k, s in state.opt_state.items()} == {'flow': 5,
                                                              'pres': 5}
  assert sorted(os.listdir(os.path.join(workdir, 'checkpoints'))) == [
      'checkpoint_0', 'checkpoint_1']
  meta = os.path.join(workdir, 'checkpoints-meta')
  saved = {name: torch.load(os.path.join(meta, name), weights_only=True)
           for name in ('checkpoint', 'checkpoint_pinn')}
  assert saved['checkpoint']['step'] == 3
  assert saved['checkpoint']['opt_state']['pres']['count'] == 3
  assert saved['checkpoint_pinn']['step'] == 7
  assert saved['checkpoint_pinn']['opt_state']['flow']['count'] == 4
  phase1_end = torch.load(os.path.join(workdir, 'checkpoints',
                                       'checkpoint_0'), weights_only=True)
  name = 'flownet.FinalUpsample_0.ConvUp_0.Conv_2.kernel'
  assert not torch.equal(state.params[name], phase1_end['params'][name])

  # The second call re-runs phase 1 after its preemption checkpoint (step
  # 3), then phase 2 from checkpoint_pinn (steps 7 .. 9).
  history = []
  resumed = pinn_lib.train(_train_config(6), workdir, device='cpu',
                           history=history)
  assert [(h['phase'], h['step']) for h in history] == [
      ('prelim', 3), ('pinn', 7), ('pinn', 8), ('pinn', 9)]
  assert resumed.step == 10
  assert resumed.opt_state['pres'].count == 7


# -- against the JAX package (slow) -----------------------------------------

@pytest.mark.slow
def test_two_pinn_steps_match_jax():
  """Two phase-2 steps of the port and of the JAX ``get_pinn_step_fn`` from
  one randomised state, on the same batches, masks and injected noise
  (JAX's ``r1, r2 = split(rng)`` draws), ``pinn_loss_weight`` 1 so that
  the residual's gradient counts: the three losses, every parameter, both
  groups' mu, nu and count, the EMA and the step."""
  import jax
  import jax.numpy as jnp
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu.pinn import losses as jax_losses
  from b_pinn_kalman_filter_tpu.train import state as jax_state
  from b_pinn_kalman_filter_tpu_torch.models import convert
  from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
  from tests.test_torch_pinn_prelim import _adam, _unmasked

  jax_config = jax_configs.get_config('pinn/pinn_pde')
  for (block, key), value in TINY.items():
    setattr(getattr(jax_config, block), key, value)
  jax_config.training.pinn_loss_weight = 1.0
  config = _config(pinn_loss_weight=1.0)
  model = port_parity.jax_pinn(jax_config)
  params = port_parity.randomized_params(
      port_parity.pinn_param_shapes(jax_config), seed=11)
  j_tx = jax_losses.get_pinn_optimizer(jax_config, lr_mul_pres=0.005)
  j_step = jax.jit(jax_losses.get_pinn_step_fn(jax_config, model, j_tx,
                                               train=True),
                   compiler_options=port_parity.FAST_COMPILE)
  j_state = jax_state.create_train_state(
      jax.tree_util.tree_map(jnp.asarray, params), j_tx,
      jax_config.model.ema_rate)

  port = PINN(config).eval()
  state = convert.train_state_from_jax(j_state, port)
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.005)
  step_fn = pinn_losses.get_pinn_step_fn(config, port, tx, train=True)
  for step in range(2):
    batch, mask = _batch(20 + step)
    rng = jax.random.PRNGKey(step)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(r, f.shape)))
                  for r, f in zip(jax.random.split(rng), batch[:2]))
    j_state, j_losses = j_step(rng, j_state, jnp.asarray(mask),
                               tuple(map(jnp.asarray, batch)))
    state, p_losses = step_fn(state, torch.from_numpy(mask),
                              tuple(map(torch.from_numpy, batch)),
                              noise=noise)
    for got, want in zip(p_losses, j_losses):
      assert port_parity._rel(got.numpy(), want) <= TOL
    got = convert.train_state_to_jax(state)
    assert got['step'] == int(j_state.step) == step + 1
    port_parity.compare_trees(got['params'], j_state.params, TOL,
                              f'params {step}')
    port_parity.compare_trees(got['ema_params'], j_state.ema_params, TOL,
                              f'ema {step}')
    for label in ('flow', 'pres'):
      adam = _adam(j_state.opt_state, label)
      assert got['count'][label] == int(adam.count) == step + 1
      port_parity.compare_trees(got['mu'][label], _unmasked(adam.mu), TOL,
                                f'mu {label} {step}')
      port_parity.compare_trees(got['nu'][label], _unmasked(adam.nu), TOL,
                                f'nu {label} {step}')
