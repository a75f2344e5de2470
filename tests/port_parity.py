"""Shared set-up for the parity tests of the PyTorch port against the JAX
package: one tiny DDPM config applied to both packages' config trees, and
flax params with every leaf randomised from a numpy seed."""

import math

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """Compare on one torch thread (xdist runs several workers per host);
  the worker's previous setting is restored after the module."""
  previous = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(previous)


# nf 32 keeps GroupNorm(min(32, C)) well defined; two levels at 8x8 and
# 4x4 with attention at 8x8 exercise the down, middle and up attention.
TINY_DDPM = {
    ('data', 'image_size'): 8,
    ('data', 'num_channels'): 3,
    ('model', 'nf'): 32,
    ('model', 'ch_mult'): (1, 2),
    ('model', 'num_res_blocks'): 1,
    ('model', 'attn_resolutions'): (8,),
    ('model', 'num_scales'): 4,
    ('tpu', 'compute_dtype'): 'float32',
}


def tiny_configs():
  """The flagship config of each package, cut to ``TINY_DDPM``."""
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  out = []
  for mod in (jax_configs, torch_configs):
    config = mod.get_config('vp/cifar10_ddpmpp_continuous')
    for (block, key), value in TINY_DDPM.items():
      setattr(getattr(config, block), key, value)
    out.append(config)
  return tuple(out)


def randomized_params(params, seed=0):
  """Every leaf of a flax params tree redrawn as numpy float32: kernels
  ~ N(0, 1/fan_in), biases ~ N(0, 0.1), GroupNorm scales ~ 1 + N(0, 0.1)."""
  rng = np.random.default_rng(seed)

  def redraw(tree):
    out = {}
    for key, value in tree.items():
      if hasattr(value, 'items'):
        out[key] = redraw(value)
        continue
      shape = tuple(value.shape)
      if len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1]))
        leaf = rng.standard_normal(shape) / np.sqrt(fan_in)
      elif key == 'scale':
        leaf = 1.0 + 0.1 * rng.standard_normal(shape)
      else:
        leaf = 0.1 * rng.standard_normal(shape)
      out[key] = leaf.astype(np.float32)
    return out

  return redraw(params)


def jax_tiny_model(config, seed=0, compiler_options=None):
  """(jitted flax ``apply(params, x, labels)`` of the config's model,
  randomised params as nested numpy dicts).  The init is only
  shape-traced: every leaf is redrawn anyway, and tracing is seconds
  faster than running it."""
  import jax
  import jax.numpy as jnp
  from b_pinn_kalman_filter_tpu import models as mutils
  model = mutils.create_model(config)
  size, ch = config.data.image_size, config.data.num_channels
  shapes = jax.eval_shape(lambda: model.init(
      {'params': jax.random.PRNGKey(seed), 'dropout': jax.random.PRNGKey(0)},
      jnp.zeros((1, size, size, ch)), jnp.zeros((1,)), train=False))
  apply = jax.jit(lambda p, x, labels: model.apply(
      {'params': p}, x, labels, train=False),
      compiler_options=compiler_options)
  return apply, randomized_params(shapes['params'], seed)


# NCSN++ at tests/tiny_configs.py's size: 16x16x1, nf 8, ch_mult (1, 2),
# one res block, attention at 8x8, in f32.  The variants are those of
# tests/test_torch_port_ncsnpp.py: 've' the published
# ve/cifar10_ncsnpp_continuous axis set (Fourier, FIR, BigGAN,
# progressive_input 'residual'), 'vp' vp/cifar10_ncsnpp_continuous's
# (positional, no FIR, no pyramid), 'skip_sum' and 'skip_cat' the 256^2
# configs' output_skip + input_skip, and 'ddpm' the DDPM resblocks.
TINY_NCSNPP = {
    ('data', 'image_size'): 16,
    ('data', 'num_channels'): 1,
    ('training', 'batch_size'): 4,
    ('eval', 'batch_size'): 4,
    ('model', 'nf'): 8,
    ('model', 'ch_mult'): (1, 2),
    ('model', 'num_res_blocks'): 1,
    ('model', 'attn_resolutions'): (8,),
    ('model', 'num_scales'): 20,
    ('optim', 'warmup'): 2,
    ('tpu', 'compute_dtype'): 'float32',
}
NCSNPP_VARIANTS = {
    've': {},
    'vp': {('model', 'embedding_type'): 'positional',
           ('model', 'fir'): False,
           ('model', 'progressive_input'): 'none',
           ('model', 'scale_by_sigma'): False,
           ('data', 'centered'): True},
    'skip_sum': {('model', 'progressive'): 'output_skip',
                 ('model', 'progressive_input'): 'input_skip',
                 ('model', 'progressive_combine'): 'sum'},
    'skip_cat': {('model', 'progressive'): 'output_skip',
                 ('model', 'progressive_input'): 'input_skip',
                 ('model', 'progressive_combine'): 'cat'},
}
# The residual output pyramid, which no published config takes.
NCSNPP_VARIANTS['residual'] = {('model', 'progressive'): 'residual'}
NCSNPP_VARIANTS['ddpm'] = {**NCSNPP_VARIANTS['vp'],
                           ('model', 'resblock_type'): 'ddpm',
                           ('model', 'skip_rescale'): False}


def tiny_ncsnpp_configs(variant='ve'):
  """``ve/cifar10_ncsnpp_continuous`` of each package, cut to
  ``TINY_NCSNPP`` and set to ``variant``."""
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  out = []
  for mod in (jax_configs, torch_configs):
    config = mod.get_config('ve/cifar10_ncsnpp_continuous')
    for (block, key), value in {**TINY_NCSNPP,
                                **NCSNPP_VARIANTS[variant]}.items():
      setattr(getattr(config, block), key, value)
    out.append(config)
  return tuple(out)


def ncsnpp_inputs(config, seed=0, batch=2):
  """(x in [0, 1], time labels) as numpy float32: noise levels between
  sigma_min and sigma_max for Fourier features, timesteps in [0, 999)
  for positional ones."""
  rng = np.random.default_rng(seed)
  size, ch = config.data.image_size, config.data.num_channels
  x = rng.uniform(0.05, 0.95, (batch, size, size, ch)).astype(np.float32)
  if config.model.embedding_type == 'fourier':
    labels = np.exp(rng.uniform(np.log(config.model.sigma_min),
                                np.log(config.model.sigma_max), batch))
  else:
    labels = rng.uniform(0, 999, batch)
  return x, labels.astype(np.float32)

# The PINN/UKF size of tests/test_ukf.py:_kf_config: 16x16 fields, two
# pyramid levels, 4x4 patches (64 filters of dimension 16).
TINY_PINN = {
    ('data', 'image_size'): 16,
    ('kf', 'patch_size'): 4,
    ('model', 'feature_nums'): (4, 8),
    ('training', 'batch_size'): 1,
}


def tiny_pinn_configs():
  """``pinn/pinn_pde`` of each package, cut to ``TINY_PINN``."""
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  out = []
  for mod in (jax_configs, torch_configs):
    config = mod.get_config('pinn/pinn_pde')
    for (block, key), value in TINY_PINN.items():
      setattr(getattr(config, block), key, value)
    out.append(config)
  return tuple(out)


def jax_pinn(config):
  from b_pinn_kalman_filter_tpu.pinn.pinn import PINN
  return PINN(config)


def pinn_param_shapes(config):
  """The flax PINN's params tree of shape structs (init only traced)."""
  import jax
  import jax.numpy as jnp
  size = config.data.image_size
  f = jnp.zeros((1, size, size, config.data.num_channels))
  return jax.eval_shape(lambda: jax_pinn(config).init(
      jax.random.PRNGKey(0), f, f, f, f, jnp.zeros((1,)),
      train=False))['params']


def posterior_eps(rng, bparams, name_hash):
  """The standard normals that JAX ``bayes.sample_params(rng, bparams)``
  draws, bit for bit, for use inside a jitted program; ``name_hash``
  stands for the ``hash`` it folds into the key.

  ``sample_params`` draws one ``jax.random.normal`` per leaf, 123 threefry
  programs for the tiny PINN, whose tracing and compiling took most of a
  B-PINN test's time.  Here the leaves are grouped by size, rounded up to
  a power of 4, and each group is one vmapped draw of that many normals
  per leaf key, cut to the leaf: threefry's counter is the element's flat
  index, so ``normal(k, shape)`` is the first ``size`` values of
  ``normal(k, (n,))`` for any n >= size, reshaped."""
  import jax
  out = {}
  for key in bparams:
    leaves, treedef = jax.tree_util.tree_flatten(bparams[key]['mu'])
    keys = jax.random.split(
        jax.random.fold_in(rng, name_hash(key) % (2 ** 31)), len(leaves))
    groups = {}
    for i, leaf in enumerate(leaves):
      groups.setdefault(4 ** math.ceil(math.log(leaf.size, 4) - 1e-9),
                        []).append(i)
    eps = [None] * len(leaves)
    for n, idx in groups.items():
      flat = jax.vmap(lambda k, n=n, dtype=leaves[idx[0]].dtype:
                      jax.random.normal(k, (n,), dtype))(keys[np.asarray(idx)])
      for row, i in enumerate(idx):
        eps[i] = flat[row, :leaves[i].size].reshape(leaves[i].shape)
    out[key] = jax.tree_util.tree_unflatten(treedef, eps)
  return out


def pinn_inputs(batch=1, size=16, seed=0):
  """(f1, f2, x, y, t) as numpy float32: two random frames, the unit
  coordinate grids and times 1, 2, ..."""
  rng = np.random.default_rng(seed)
  f1, f2 = rng.random((2, batch, size, size, 1)).astype(np.float32)
  xs, ys = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size))
  x = np.broadcast_to(xs[None, :, :, None], f1.shape).astype(np.float32)
  y = np.broadcast_to(ys[None, :, :, None], f1.shape).astype(np.float32)
  t = np.arange(1, batch + 1, dtype=np.float32)
  return f1, f2, x, y, t


# The train step's parity (tests/test_torch_train*.py): the flagship
# optimizer with warmup 2, so that steps 0, 1, 2 take lr 0, lr / 2 and lr,
# the clip at 1.0 active; and a case with coupled weight decay and a clip
# too large to act.  Dropout is 0: masks cannot be shared across
# frameworks.  Limits, relative to max |JAX| over each tree: 1e-4 for the
# loss and the parameters; 1e-5 for the Adam moments, the optimizer's
# updates from equal gradients and the EMA step from equal inputs.
# Through three steps the EMA, a mix of the parameters, is held to the
# parameters' 1e-4: Adam divides by sqrt(nu), so an element whose gradient
# is small takes an update with its gradient's relative error, up to ~lr.
TRAIN_CASES = {'flagship': dict(warmup=2),
               'decay': dict(warmup=2, weight_decay=0.05, grad_clip=1e6)}
LOSS_TOL = 1e-4
LEAF_TOL = 1e-4
MOMENT_TOL = 1e-5
TRAIN_BATCH = 4
# XLA's lowest backend optimisation level: the JAX steps compile in
# seconds less and run a few times each.
FAST_COMPILE = {'xla_backend_optimization_level': 0,
                'xla_llvm_disable_expensive_passes': True}


def jax_state_init(tx, ema_rate):
  """JAX ``state.create_train_state(params, tx, ema_rate)`` jitted: one
  program, where the eager call compiles each of its zeros and copies
  for each leaf shape."""
  import jax
  from b_pinn_kalman_filter_tpu.train import state as jax_state
  return jax.jit(lambda params: jax_state.create_train_state(params, tx,
                                                             ema_rate))


def train_configs(case):
  """(the JAX config's ``optim`` block as a namespace, the port's config)
  of ``case``, dropout 0.  (ml_collections keeps ``weight_decay`` an int.)"""
  import types
  jax_config, torch_config = tiny_configs()
  optim = dict(jax_config.optim.to_dict(), **TRAIN_CASES[case])
  torch_config.optim.update(TRAIN_CASES[case])
  torch_config.model.dropout = 0.0
  return (types.SimpleNamespace(optim=types.SimpleNamespace(**optim)),
          torch_config)


def jax_train_side(case):
  """The JAX side of ``case``: randomised params, the optimizer, and the
  jitted train step, eval step and EMA step (each compiled once)."""
  import types

  import jax
  from b_pinn_kalman_filter_tpu import models as jax_models
  from b_pinn_kalman_filter_tpu.core import losses as jax_losses
  from b_pinn_kalman_filter_tpu.core import sde as jax_sde
  from b_pinn_kalman_filter_tpu.train import state as jax_state
  jax_config, _ = tiny_configs()
  jax_config.model.dropout = 0.0
  model = jax_models.create_model(jax_config)
  _, params = jax_tiny_model(jax_config, seed=3)
  sde, _ = jax_sde.get_sde(jax_config)
  tx = jax_losses.get_optimizer(train_configs(case)[0])
  common = dict(reduce_mean=True, continuous=True, likelihood_weighting=False)
  rate = jax_config.model.ema_rate
  return dict(
      params=params, sde=sde, tx=tx, ema_rate=rate,
      step=jax.jit(jax_losses.get_step_fn(sde, model, tx, train=True,
                                          **common),
                   compiler_options=FAST_COMPILE),
      eval_step=jax.jit(jax_losses.get_step_fn(sde, model, tx, train=False,
                                               **common),
                        compiler_options=FAST_COMPILE),
      ema_step=jax.jit(lambda step, ema, new: jax_state.ema_update(
          types.SimpleNamespace(step=step, ema_rate=rate, ema_params=ema),
          new)))


def jax_train_noise(sde, step, shape):
  """(``PRNGKey(step)``, and as tensors the t and z the JAX loss draws
  from it: ``t_rng, z_rng, drop_rng = split(rng, 3)``)."""
  import jax
  rng = jax.random.PRNGKey(step)
  t_rng, z_rng, _ = jax.random.split(rng, 3)
  t = jax.random.uniform(t_rng, (shape[0],), minval=1e-5, maxval=sde.T)
  z = jax.random.normal(z_rng, shape)
  return rng, (torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z)))


def train_batch(seed):
  rng = np.random.default_rng(seed)
  return rng.uniform(-1, 1, (TRAIN_BATCH, 8, 8, 3)).astype(np.float32)


def leaves(tree, prefix=''):
  for key, value in tree.items():
    if hasattr(value, 'items'):
      yield from leaves(value, f'{prefix}{key}.')
    else:
      yield f'{prefix}{key}', np.asarray(value)


def compare_trees(port_tree, jax_tree, tol, what):
  """Every leaf within ``tol`` of max |JAX| over the tree (a leaf's own
  maximum can be ~0: a temb bias ahead of a one-channel GroupNorm group
  has a gradient of zero up to rounding)."""
  want = dict(leaves(jax_tree))
  got = dict(leaves(port_tree))
  assert got.keys() == want.keys(), what
  scale = max(np.abs(w).max() for w in want.values())
  errors = {name: float(np.abs(got[name] - want[name]).max()) / scale
            for name in want}
  worst = max(errors, key=errors.get)
  assert errors[worst] <= tol, (what, worst, errors[worst])


def _rel(got, want):
  want = np.asarray(want, np.float32)
  return float(np.abs(np.asarray(got) - want).max()
               / max(np.abs(want).max(), 1e-30))


def check_three_train_steps(side, case):
  """Three train steps of the port and of the JAX package from one
  randomised state under replayed t and z: after each, the loss, every
  parameter leaf, Adam's mu, nu and count, the EMA and the step (after the
  first, the parameters unchanged: the warmup's lr is 0); then one eval
  step under the EMA."""
  import jax.numpy as jnp
  from b_pinn_kalman_filter_tpu_torch.core import losses
  from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
  from b_pinn_kalman_filter_tpu_torch.models import convert, ddpm
  _, torch_config = train_configs(case)
  tx = losses.get_optimizer(torch_config)
  j_state = jax_state_init(side['tx'], side['ema_rate'])(side['params'])
  model = ddpm.DDPM(torch_config).eval()
  state = convert.train_state_from_jax(j_state, model)
  sde, _ = sde_lib.get_sde(torch_config)
  step_fn = losses.get_step_fn(sde, model, tx, train=True, reduce_mean=True,
                               continuous=True)

  # The clip acts in the flagship case and not in the decay case.
  batch = train_batch(0)
  _, noise = jax_train_noise(side['sde'], 0, batch.shape)
  loss = losses.get_sde_loss_fn(sde, model, True, reduce_mean=True,
                                likelihood_weighting=False)(
      state.params, torch.from_numpy(batch), noise=noise)
  norm = float(torch.linalg.vector_norm(torch.stack([
      g.norm() for g in torch.autograd.grad(loss, list(state.params.values()))
  ])))
  assert (norm >= torch_config.optim.grad_clip) == (case == 'flagship')

  for step in range(3):
    batch = train_batch(step)
    rng, noise = jax_train_noise(side['sde'], step, batch.shape)
    before = convert.train_state_to_jax(state)
    j_before = j_state.params
    j_state, j_loss = side['step'](rng, j_state, jnp.asarray(batch))
    state, p_loss = step_fn(state, torch.from_numpy(batch), noise=noise)
    assert _rel(p_loss.numpy(), j_loss) <= LOSS_TOL
    got = convert.train_state_to_jax(state)
    adam = j_state.opt_state[-1][0]
    assert got['step'] == int(j_state.step) == step + 1
    assert got['count'] == int(adam.count) == step + 1
    compare_trees(got['params'], j_state.params, LEAF_TOL, f'params {step}')
    compare_trees(got['mu'], adam.mu, MOMENT_TOL, f'mu {step}')
    compare_trees(got['nu'], adam.nu, MOMENT_TOL, f'nu {step}')
    # The EMA step on the port's own inputs, by the JAX function.
    want_ema = side['ema_step'](jnp.asarray(step, jnp.int32),
                                before['ema_params'], got['params'])
    compare_trees(got['ema_params'], want_ema, MOMENT_TOL,
                  f'ema step {step}')
    # The EMA is a mix of the parameters and follows them to their limit.
    compare_trees(got['ema_params'], j_state.ema_params, LEAF_TOL,
                  f'ema {step}')
    if step == 0:
      # Warmup: optax reads the count before its increment, lr * 0 / 2.
      for tree, start in ((got['params'], before['params']),
                          (j_state.params, j_before)):
        assert all(np.array_equal(np.asarray(v), w) for (_, v), (_, w) in
                   zip(leaves(tree), leaves(start)))

  rng, noise = jax_train_noise(side['sde'], 7, batch.shape)
  _, j_eval = side['eval_step'](rng, j_state, jnp.asarray(batch))
  eval_fn = losses.get_step_fn(sde, model, tx, train=False, reduce_mean=True,
                               continuous=True)
  _, p_eval = eval_fn(state, torch.from_numpy(batch), noise=noise)
  assert _rel(p_eval.numpy(), j_eval) <= LOSS_TOL
  assert state.step == 3
