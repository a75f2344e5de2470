"""The B-PINN step: the port's ``pinn/bayes.py`` ``kl_loss``,
``get_bpinn_loss_fn`` and ``get_bpinn_prelim_step_fn`` against the JAX
package's on the same randomised MOPED posterior, mask, noises, draw and
batch (f32, CPU, ``feature_nums`` (4,), 8x8, batch 2), and the B-PINN
train state across the converters and checkpoints.

The KL parts of the summed losses are thousands of times the data MSEs,
so the sums' rounding would hide an error in the data path.  The JAX step
is therefore jitted together with its loss's four terms apart (on the
same draw: JAX's ``sample_params`` written out beside it, and checked
against it), and each term is compared on its own.  ``sample_params`` folds ``hash(key)``
into the key, salted per process; the module fixture puts CRC-32 in its
place (``tests/test_torch_pinn_kf.py``).

Limits: ``kl_loss`` 1e-5 of itself; the losses and each term 1e-4 of
itself; mu and rho of each sub-network, both groups' Adam moments and the
EMA 1e-4 of max |JAX| over each tree (``tests/port_parity.py``)."""

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.models import flownet as jax_flownet
from b_pinn_kalman_filter_tpu.pinn import bayes as jax_bayes
from b_pinn_kalman_filter_tpu.pinn import losses as jax_losses
from b_pinn_kalman_filter_tpu_torch.models import convert
from b_pinn_kalman_filter_tpu_torch.pinn import bayes
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train.state import create_train_state
from tests import port_parity
from tests.port_parity import compare_trees
from tests.port_parity import one_torch_thread  # noqa: F401

KL_TOL = 1e-5
TOL = 1e-4
BATCH, SIZE = 2, 8
# Warmup 2: the steps take lr 0 and lr / 2 (bpinn_lr 5e-4), so that the
# second step moves every leaf; the PressureNet's lr x 0.05, as
# train_bpinn sets it.
BPINN = {('data', 'image_size'): SIZE,
         ('model', 'feature_nums'): (4,),
         ('training', 'batch_size'): BATCH,
         ('optim', 'warmup'): 2}
LR_MUL_PRES = 0.05
TERMS = ('flow_mse', 'pres_mse', 'kl_flow', 'kl_pres')


def _configs():
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  out = []
  for mod in (jax_configs, torch_configs):
    config = mod.get_config('pinn/pinn_pde')
    for (block, key), value in BPINN.items():
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


def _eps(draw_rng, bparams):
  """The standard normals JAX's ``sample_params(draw_rng, bparams)`` draws
  (with the fixture's CRC-32 ``hash``), by ``port_parity.posterior_eps``."""
  return port_parity.posterior_eps(draw_rng, bparams,
                                   lambda key: zlib.crc32(key.encode()))


@pytest.fixture(scope='module')
def side():
  """The JAX side: configs, the randomised PINN's MOPED and prior-rho
  posteriors, the optimizer and its state's initialiser, ``kl_loss`` and
  the train step jitted with its loss's terms, noises and draw (each
  compiled once)."""
  from b_pinn_kalman_filter_tpu.pinn.pinn import PINN as JaxPINN
  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(jax_bayes, 'hash', lambda key: zlib.crc32(key.encode()),
                  raising=False)
    jax_config, torch_config = _configs()
    model = JaxPINN(jax_config)
    params = port_parity.randomized_params(
        port_parity.pinn_param_shapes(jax_config), seed=4)
    make = jax.jit(lambda p: {
        pretrained: jax_bayes.make_bpinn_params(p, jax_config, pretrained)
        for pretrained in (True, False)})
    posteriors = make(params)
    tx = jax_losses.get_pinn_optimizer(jax_config, lr_mul_pres=LR_MUL_PRES,
                                       is_bpinn=True)
    step = jax_bayes.get_bpinn_prelim_step_fn(jax_config, model, tx,
                                              train=True)
    variance = jax_config.inverse.variance

    def step_and_terms(rng, state, mask, batch):
      """JAX's step, and its loss's terms on the step's own draws."""
      new_state, losses = step(rng, state, mask, batch)
      f1, f2, x, y, t, target = batch
      r1, r2, draw_rng = jax.random.split(rng, 3)
      noise = tuple(jax.random.normal(r, f1.shape) for r in (r1, r2))
      f1m, f2m = (mask * f + n * variance ** 0.5
                  for f, n in zip((f1, f2), noise))
      draw = jax_bayes.sample_params(draw_rng, state.params)
      flow = model.apply({'params': draw}, f1m, f2m, x, y, t, train=True,
                         method=model.flow_only)
      pres = model.apply({'params': draw},
                         jax_losses._gt_flow_pyramid(jax_config, target),
                         x, y, t, train=True, method=model.pressure_only)
      terms = (jax_flownet.multiscale_data_mse(flow, target),
               jax_flownet.pressure_data_mse(pres, target)
               ) + jax_bayes.kl_loss(state.params)
      return (new_state, losses, dict(zip(TERMS, terms)), noise,
              _eps(draw_rng, state.params), draw)

    yield types.SimpleNamespace(
        jax_config=jax_config, torch_config=torch_config, tx=tx,
        posteriors=posteriors,
        init=port_parity.jax_state_init(tx, jax_config.model.ema_rate),
        kl=jax.jit(jax_bayes.kl_loss),
        step=jax.jit(step_and_terms,
                     compiler_options=port_parity.FAST_COMPILE))


def _port(side):
  """The port's model, optimizer and train, eval and loss functions."""
  config = side.torch_config
  model = PINN(config).eval()
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=LR_MUL_PRES,
                                      is_bpinn=True)
  return types.SimpleNamespace(
      model=model, tx=tx,
      loss=bayes.get_bpinn_loss_fn(config, model),
      step=bayes.get_bpinn_prelim_step_fn(config, model, tx, train=True),
      eval=bayes.get_bpinn_prelim_step_fn(config, model, tx, train=False))


def _jax_state(side):
  return side.init(side.posteriors[True])


def _tensors(arrays):
  return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize('pretrained', [True, False],
                         ids=['moped', 'prior_rho'])
def test_kl_loss_matches_jax(side, pretrained):
  posterior = side.posteriors[pretrained]
  port = convert.bpinn_params_from_jax(posterior, PINN(side.torch_config))
  got = bayes.kl_loss(port)
  want = side.kl(posterior)
  for g, w in zip(got, want):
    assert port_parity._rel(g.numpy(), w) <= KL_TOL
  # The KL terms dwarf the data MSEs (~1e1 at this size).
  assert min(float(w) for w in want) > 1e4


def test_two_bpinn_steps_match_jax(side):
  port = _port(side)
  j_state = _jax_state(side)
  state = convert.train_state_from_jax(j_state, port.model)
  assert set(state.opt_state) == {'flow', 'pres'}
  assert set(state.opt_state['pres'].mu) == {
      n for n in state.params if n.startswith('pressurenet.')}

  for step in range(2):
    batch, mask = _batch(step)
    before = j_state.params
    j_state, j_losses, j_terms, noise, eps, draw = side.step(
        jax.random.PRNGKey(step), j_state, jnp.asarray(mask),
        tuple(map(jnp.asarray, batch)))
    # The written-out eps give JAX's own draw.
    redrawn = jax.tree_util.tree_map(
        lambda m, r, e: np.asarray(m) + np.logaddexp(np.asarray(r), 0.0)
        * np.asarray(e), {k: before[k]['mu'] for k in before},
        {k: before[k]['rho'] for k in before}, eps)
    compare_trees(redrawn, draw, 1e-6, f'draw {step}')
    eps = convert.draw_from_jax(eps, port.model)
    noise = _tensors(noise)
    inputs = (torch.from_numpy(mask), tuple(map(torch.from_numpy, batch)))
    with torch.no_grad():
      *_, terms = port.loss(state.params, *inputs, noise=noise, eps=eps)
    for name in TERMS:
      assert port_parity._rel(terms[name].numpy(), j_terms[name]) <= TOL, (
          name, step)
    state, losses = port.step(state, *inputs, noise=noise, eps=eps)
    for got, want in zip(losses, j_losses):
      assert port_parity._rel(got.numpy(), want) <= TOL

    got = convert.train_state_to_jax(state)
    assert got['step'] == int(j_state.step) == step + 1
    for key in ('flownet', 'pressurenet'):
      for part in ('mu', 'rho'):
        compare_trees(got['params'][key][part], j_state.params[key][part],
                      TOL, f'{key} {part} {step}')
    compare_trees(got['ema_params'], j_state.ema_params, TOL, f'ema {step}')
    for label in ('flow', 'pres'):
      adam = convert._adam_parts(j_state.opt_state.inner_states[label])
      assert got['count'][label] == int(adam.count) == step + 1
      for moment in ('mu', 'nu'):
        compare_trees(got[moment][label],
                      _unmasked(getattr(adam, moment)), TOL,
                      f'{moment} {label} {step}')
  # The second step moved every mu and rho leaf.
  start = convert.train_state_to_jax(
      convert.train_state_from_jax(_jax_state(side), port.model))
  moved = [not np.array_equal(a, b) for (_, a), (_, b) in zip(
      port_parity.leaves(got['params']),
      port_parity.leaves(start['params']))]
  assert all(moved)


def _unmasked(tree):
  """An optax moment tree without the masked nodes of the other group."""
  out = {}
  for key, value in tree.items():
    if hasattr(value, 'items'):
      value = _unmasked(value)
      if value:
        out[key] = value
    elif hasattr(value, 'shape'):
      out[key] = value
  return out


def test_eval_step_is_the_loss_under_the_ema(side):
  """The eval step's losses are the loss function's under
  ``state.ema_params`` with the same noises and draw, and leave the state
  as it was."""
  port = _port(side)
  state = convert.train_state_from_jax(_jax_state(side), port.model)
  batch, mask = _batch(0)
  inputs = (torch.from_numpy(mask), tuple(map(torch.from_numpy, batch)))
  g = torch.Generator().manual_seed(0)
  state, _ = port.step(state, *inputs, generator=g)
  state, _ = port.step(state, *inputs, generator=g)
  g = torch.Generator().manual_seed(1)
  noise = tuple(torch.randn(f.shape, generator=g) for f in inputs[1][:2])
  eps = bayes.sample_eps(g, bayes.nest_posterior(state.ema_params))
  before = {k: v.clone() for k, v in state.params.items()}
  _, got = port.eval(state, *inputs, noise=noise, eps=eps)
  with torch.no_grad():
    want = port.loss(state.ema_params, *inputs, noise=noise, eps=eps)[:3]
    train = port.loss(state.params, *inputs, noise=noise, eps=eps)[:3]
  assert all(torch.equal(a, b) for a, b in zip(got, want))
  assert not torch.equal(got[0], train[0])
  assert state.step == 2
  assert all(torch.equal(v, before[k]) for k, v in state.params.items())


def test_bpinn_state_round_trips(side, tmp_path):
  """JAX B-PINN state -> port -> JAX trees keeps every mu, rho, moment,
  count and EMA leaf, name for name; a checkpoint of it restores into a
  fresh B-PINN state."""
  port = _port(side)
  batch, mask = _batch(1)
  j_state, *_ = side.step(jax.random.PRNGKey(1), _jax_state(side),
                          jnp.asarray(mask), tuple(map(jnp.asarray, batch)))
  state = convert.train_state_from_jax(j_state, port.model)
  assert list(state.params) == list(bayes.flatten_posterior(
      convert.bpinn_params_from_jax(j_state.params, port.model)))
  got = convert.train_state_to_jax(state)
  compare_trees(got['params'], j_state.params, 0.0, 'params')
  compare_trees(got['ema_params'], j_state.ema_params, 0.0, 'ema')
  for label in ('flow', 'pres'):
    adam = convert._adam_parts(j_state.opt_state.inner_states[label])
    for moment in ('mu', 'nu'):
      compare_trees(got[moment][label], _unmasked(getattr(adam, moment)),
                    0.0, moment)
    assert got['count'][label] == int(adam.count) == 1

  path = str(tmp_path / 'checkpoint')
  ckpt_lib.save_checkpoint(path, state)
  fresh = create_train_state(
      {k: torch.zeros_like(v) for k, v in state.params.items()}, port.tx,
      side.torch_config.model.ema_rate)
  back = convert.train_state_to_jax(ckpt_lib.restore_checkpoint(path, fresh))
  assert back['step'] == 1 and back['count'] == {'flow': 1, 'pres': 1}
  for key in ('params', 'ema_params'):
    compare_trees(back[key], got[key], 0.0, key)
  for key in ('mu', 'nu'):
    for label in ('flow', 'pres'):
      compare_trees(back[key][label], got[key][label], 0.0, key)
