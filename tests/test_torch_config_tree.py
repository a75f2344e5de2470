"""The port's config tree against the JAX package's: every JAX config but
``tpu_defaults.py`` (TPU defaults) has a port counterpart, and the 25 that
came with the NCSN/NCSNv2 models and the discrete DDPM blocks hold the
JAX keys and values (no JAX program) and train one step on the CPU at a
tiny variant through their own entry point (``run_lib.train``: the
config's dataset stand-in, SDE and loss; ``pinn/pinn_nc`` a PINN prelim
step, with ``pinn/pinn_pde``'s ``data.dt`` and ``inverse`` block, which
it lacks in both packages).  Also: ``ve/ncsn/*`` leave ``model.num_classes`` unset, and the
``ncsn`` model raises on them in both packages; the NCSNv2 variant by
image size; ``tpu.remat`` at the DDPM; and ``run_lib.train``
and an annealed-Langevin ``run_lib.sample`` request at a tiny
``ve/ncsnv2/cifar10``."""

import os

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.data import datasets
from b_pinn_kalman_filter_tpu_torch.models import ncsnv2, registry
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn import pinn_lib
from b_pinn_kalman_filter_tpu_torch.train import run_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401
from tests.test_torch_package import _check_config_keys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NCSN = ['ve/ncsn/cifar10', 've/ncsn/cifar10_124', 've/ncsn/cifar10_1245',
        've/ncsn/cifar10_5', 've/ncsn/celeba', 've/ncsn/celeba_124',
        've/ncsn/celeba_1245', 've/ncsn/celeba_5']
NCSNV2 = ['ve/ncsnv2/cifar10', 've/ncsnv2/celeba', 've/ncsnv2/bedroom']
DDPM = ['vp/ddpm/cifar10', 'vp/ddpm/cifar10_continuous',
        'vp/ddpm/cifar10_unconditional', 'vp/ddpm/bedroom', 'vp/ddpm/church',
        'vp/ddpm/celebahq', 'vp/cifar10_ddpmpp',
        'vp/cifar10_ddpmpp_deep_continuous', 've/cifar10_ddpm',
        'subvp/cifar10_ddpm_continuous', 'subvp/cifar10_ddpmpp_continuous',
        'subvp/cifar10_ddpmpp_deep_continuous', 'vp/nc_chl_ddpmpp']
CONFIGS = NCSN + NCSNV2 + DDPM + ['pinn/pinn_nc']


def _tree(package):
  base = os.path.join(ROOT, package, 'configs')
  return {os.path.relpath(os.path.join(d, f), base)
          for d, _, files in os.walk(base) for f in files
          if f.endswith('.py')}


def test_every_jax_config_has_a_port_counterpart():
  want = _tree('b_pinn_kalman_filter_tpu') - {'tpu_defaults.py'}
  got = _tree('b_pinn_kalman_filter_tpu_torch')
  assert sorted(want - got) == []
  # The port's own additions: its attribute dict, nothing else.
  assert sorted(got - want) == ['config_dict.py']


@pytest.mark.parametrize('name', CONFIGS)
def test_config_has_the_jax_keys_and_values(name):
  _check_config_keys(name)


def tiny_config(name):
  """``name`` at a tiny width: nf 8, 16x16 (32x32 for ``ncsnv2_128``),
  the DDPM U-Nets' levels cut to three with one res block each, batch 2,
  f32; ``ncsn`` with ``num_classes = num_scales``; the NC field under
  ``$BPKF_DATA_DIR``, cut by 2 land rows; the PINN at
  ``port_parity.TINY_PINN``."""
  config = configs.get_config(name)
  if config.data.dataset == 'NC_P':
    config.data.image_size = port_parity.TINY_PINN[('data', 'image_size')]
    config.model.feature_nums = port_parity.TINY_PINN[
        ('model', 'feature_nums')]
    config.training.batch_size = 1
    return config
  m = config.model
  config.training.batch_size = 2
  config.eval.batch_size = 2
  config.tpu.compute_dtype = 'float32'
  m.nf = 8
  config.data.image_size = 32 if m.name == 'ncsnv2_128' else 16
  if m.name == 'ncsn':
    m.num_classes = m.num_scales
  if m.name == 'ddpm':
    m.ch_mult = tuple(m.ch_mult[:3])
    m.num_res_blocks = 1
  if config.data.dataset == 'NC':
    config.data.land_cut = 2
  return config


def _nc_file(data, config):
  data.mkdir(exist_ok=True)
  field = datasets.smooth_field(np.random.default_rng(0), (12, 1, 20, 20), 4)
  np.savez(data / f'bsose_i122_{config.data.date_range}_'
           f'{config.data.category}.nc.npz',
           **{config.data.key: field.astype(np.float32)})


@pytest.mark.parametrize('name', CONFIGS)
def test_config_trains_one_step_on_the_cpu(name, tmp_path, monkeypatch):
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  config = tiny_config(name)
  if name == 'pinn/pinn_nc':
    _pinn_step(config)
    return
  if config.data.dataset == 'NC':
    _nc_file(tmp_path / 'data', config)
  config.training.n_iters = 0         # step 0: the train step and an eval
  history = []
  state = run_lib.train(config, str(tmp_path / 'w'), device='cpu',
                        history=history)
  assert [h['step'] for h in history] == [0]
  assert 'eval' in history[0]['events']
  assert np.isfinite(history[0]['loss']) and state.step == 1
  assert all(torch.isfinite(p).all() for p in state.params.values())


def _pinn_step(config):
  """One PINN prelim step of ``pinn/pinn_nc``'s model at a tiny size, on a
  seeded batch of the PDE loader's layout.  As published the config lacks
  ``data.dt`` (the FlowNet's time step) and the ``inverse`` block (the
  noise variance that the PINN steps read), and its ``NC_P`` loader
  yields (frame, label) pairs, not the PINN's (f1, f2, x, y, t, target),
  in both packages: the step takes ``pinn/pinn_pde``'s ``dt`` and
  block."""
  pde = configs.get_config('pinn/pinn_pde')
  with pytest.raises(AttributeError, match='dt'):
    pinn_lib.init_pinn(config, seed=0, device='cpu')
  config.data.dt = pde.data.dt
  model, _ = pinn_lib.init_pinn(config, seed=0, device='cpu')
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.001)
  state = state_lib.create_train_state(dict(model.named_parameters()), tx,
                                       config.model.ema_rate)
  f1, f2, x, y, t = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                     port_parity.pinn_inputs(1, config.data.image_size))
  target = torch.randn(f1.shape[:-1] + (3,),
                       generator=torch.Generator().manual_seed(0))
  mask = torch.ones(f1.shape[1:])
  batch = (f1, f2, x, y, t, target)
  step_fn = pinn_losses.get_prelim_step_fn(config, model, tx, train=True)
  with pytest.raises(AttributeError, match='inverse'):
    step_fn(state, mask, batch, torch.Generator().manual_seed(1))
  config.inverse = pde.inverse
  step_fn = pinn_losses.get_prelim_step_fn(config, model, tx, train=True)
  state, (loss, _, _) = step_fn(state, mask, batch,
                                torch.Generator().manual_seed(1))
  assert np.isfinite(float(loss)) and state.step == 1


def test_pinn_nc_lacks_dt_and_the_inverse_block_in_both_packages():
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu.pinn import losses as jax_pinn_losses
  jax_config = jax_configs.get_config('pinn/pinn_nc')
  for config in (jax_config, configs.get_config('pinn/pinn_nc')):
    assert 'inverse' not in config and 'dt' not in config.data
  with pytest.raises(AttributeError, match='inverse'):
    jax_pinn_losses.get_prelim_step_fn(jax_config, None, None, train=True)


def test_ncsn_configs_lack_num_classes_in_both_packages():
  """``ve/ncsn/cifar10`` as published: the ``ncsn`` model reads
  ``model.num_classes`` for its conditional norms and raises, in the port
  as in JAX."""
  import jax
  import jax.numpy as jnp
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu import models as jax_models
  for name in NCSN:
    assert 'num_classes' not in configs.get_config(name).model
  jax_config = jax_configs.get_config('ve/ncsn/cifar10')
  jax_config.data.image_size = 16
  model = jax_models.create_model(jax_config)
  with pytest.raises(AttributeError, match='num_classes'):
    jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
        jnp.zeros((1,), jnp.int32), train=False))
  with pytest.raises(AttributeError, match='num_classes'):
    registry.create_model(configs.get_config('ve/ncsn/cifar10'),
                          device='cpu')


def test_ncsnv2_variant_by_image_size():
  config = configs.get_config('ve/ncsnv2/cifar10')
  for size, cls in ((32, ncsnv2.NCSNv2), (96, ncsnv2.NCSNv2_128),
                    (128, ncsnv2.NCSNv2_128), (256, ncsnv2.NCSNv2_256)):
    config.data.image_size = size
    assert ncsnv2.get_network(config).func is cls
  config.data.image_size = 512
  with pytest.raises(NotImplementedError):
    ncsnv2.get_network(config)
  for name in ('ncsnv2_64', 'ncsn', 'ncsnv2_128', 'ncsnv2_256'):
    assert registry.get_model(name).__name__ in (
        'NCSNv2', 'NCSN', 'NCSNv2_128', 'NCSNv2_256')


def test_ddpm_refuses_remat():
  """``tpu.remat`` at the tiny DDPM, dropout 0.1 in training: the loss
  and every gradient bit for bit as without it, the same names, the
  generator left where it was, each resblock recomputed in the backward
  (``port_parity.check_remat``)."""
  _, config = port_parity.tiny_configs()
  runs = port_parity.check_remat(config)
  assert runs[True][4][0] == 8     # 2 down, 2 middle, 2 x 2 up


def test_train_and_ald_sample_at_the_tiny_ncsnv2(tmp_path, monkeypatch):
  """``run_lib.train`` at ``ve/ncsnv2/cifar10`` (nf 8, 16x16) through the
  SMLD loss with a snapshot, then a PC request by its annealed Langevin
  corrector (predictor 'none', 5 steps a level): N levels, 5 N
  evaluations of the net (the sampler's NFE, as JAX counts it, N (5 +
  1))."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  config = tiny_config('ve/ncsnv2/cifar10')
  t = config.training
  t.n_iters, t.batch_size = 1, 8      # snapshots of batch_size // 4
  t.log_freq = t.eval_freq = t.snapshot_freq_for_preemption = 1
  t.snapshot_freq = 1
  config.model.num_scales = 3
  history = []
  state = run_lib.train(config, str(tmp_path), device='cpu',
                        history=history)
  assert [h['step'] for h in history] == [0, 1]
  assert all(np.isfinite(h['loss']) for h in history)
  assert 'snapshot' in history[-1]['events'] and state.step == 2
  samples = np.load(tmp_path / 'samples' / 'iter_1' / 'sample.np')
  assert samples.shape == (2, 16, 16, 3)

  model = registry.create_model(config, device='cpu', seed=1)
  calls = []
  model.register_forward_hook(lambda *_: calls.append(1))
  samples, nfe = run_lib.sample(config, batch_size=2, seed=1, device='cpu',
                                model=model)
  assert len(calls) == 3 * 5 and nfe == 3 * (5 + 1)
  assert samples.shape == (2, 16, 16, 3) and torch.isfinite(samples).all()
