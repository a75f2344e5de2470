"""B-PINN training and the pipeline it completes, on the CPU at tiny widths
(``feature_nums`` (4,), 8x8, batch 2, 4x4 ukf patches): ``pinn_lib.train``
(2 + 2 steps) writes a PINN snapshot; ``train_bpinn`` bootstraps the
MOPED posterior from it, trains it and resumes; ``restore_bpinn_checkpoint``
takes each of its three branches; ``ukf_lib.run`` filters with the trained
posterior.  The step itself against the JAX package:
tests/test_torch_bpinn.py."""

import os

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.kalman import ukf_lib
from b_pinn_kalman_filter_tpu_torch.pinn import bayes, pinn_lib
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from b_pinn_kalman_filter_tpu_torch.utils.misc import PNG_SIGNATURE
from tests.port_parity import one_torch_thread  # noqa: F401


def _config(**training):
  config = configs.get_config('pinn/pinn_pde')
  config.data.image_size = 8
  config.model.feature_nums = (4,)
  config.kf.patch_size = 4
  t = config.training
  t.batch_size = 2
  t.n_iters = 2
  t.n_pinn_iters = 2
  t.n_bpinn_iters = 0
  t.log_freq = 2
  t.eval_freq = 2
  t.snapshot_freq_for_preemption = 2
  t.snapshot_freq = 2
  t.update(training)
  return config


@pytest.fixture(scope='module')
def run_dir(tmp_path_factory):
  """A directory with the synthetic data and a PINN trained 2 + 2 steps
  (``pinn/checkpoints/checkpoint_2``, its last snapshot)."""
  base = tmp_path_factory.mktemp('bpinn')
  with pytest.MonkeyPatch.context() as patch:
    patch.setenv('BPKF_DATA_DIR', str(base / 'data'))
    pinn_lib.train(_config(), str(base / 'pinn'), device='cpu')
    yield base


def _snapshot(run_dir):
  return str(run_dir / 'pinn' / 'checkpoints' / 'checkpoint_2')


@pytest.fixture
def data_dir(run_dir, monkeypatch):
  monkeypatch.setenv('BPKF_DATA_DIR', str(run_dir / 'data'))


def _parts(state, part):
  """``{'<key>.<name>': tensor}`` of the posterior's ``part``."""
  return {f'{key}.{name}': value
          for key, parts in bayes.nest_posterior(state).items()
          for name, value in parts[part].items()}


def test_train_bpinn_bootstraps_moped_from_the_pinn_snapshot(
    run_dir, data_dir, tmp_path):
  """Step 0 takes lr 0 (warmup), so the state after it is the bootstrap:
  mu the PINN snapshot's ``ema_params`` bit for bit, rho
  ``inv_softplus(delta |w|)``, the EMA the same posterior."""
  config = _config()
  saved = torch.load(_snapshot(run_dir), weights_only=True)['ema_params']
  state = pinn_lib.train_bpinn(config, str(tmp_path), _snapshot(run_dir),
                               device='cpu')
  assert state.step == 1
  delta = config.model.bpinn_moped_delta
  for tree in (state.params, state.ema_params):
    mu, rho = _parts(tree, 'mu'), _parts(tree, 'rho')
    assert mu.keys() == saved.keys()
    for name, w in saved.items():
      assert torch.equal(mu[name], w), name
      assert torch.equal(rho[name], bayes.inv_softplus(delta * w.abs()))
  assert {label: s.count for label, s in state.opt_state.items()} == {
      'flow': 1, 'pres': 1}


@pytest.mark.parametrize('ckpt', [None, 'missing'])
def test_train_bpinn_without_a_checkpoint_takes_the_priors_rho(
    data_dir, tmp_path, ckpt):
  config = _config()
  ckpt_dir = None if ckpt is None else str(tmp_path / ckpt)
  state = pinn_lib.train_bpinn(config, str(tmp_path / 'work'), ckpt_dir,
                               device='cpu')
  _, init = pinn_lib.init_pinn(config, seed=config.seed + 7, device='cpu')
  mu, rho = _parts(state.params, 'mu'), _parts(state.params, 'rho')
  for key, prior in bayes.KEYS:
    for name, w in init[key].items():
      assert torch.equal(mu[f'{key}.{name}'], w)
      assert torch.equal(rho[f'{key}.{name}'], torch.full_like(
          w, prior['posterior_rho_init']))


def test_train_bpinn_trains_every_leaf_and_resumes(run_dir, data_dir,
                                                   tmp_path):
  workdir = str(tmp_path)
  history = []
  state = pinn_lib.train_bpinn(_config(n_bpinn_iters=4), workdir,
                               _snapshot(run_dir), device='cpu',
                               history=history)
  assert [(h['phase'], h['step']) for h in history] == [
      ('bpinn', s) for s in range(5)]
  assert [h['events'] for h in history] == [
      ['log', 'eval'], [], ['log', 'eval', 'preempt_ckpt', 'snapshot'], [],
      ['log', 'eval', 'preempt_ckpt', 'snapshot']]
  assert all(np.isfinite(h['loss']) for h in history)
  assert state.step == 5
  assert {s.count for s in state.opt_state.values()} == {5}
  start = torch.load(_snapshot(run_dir), weights_only=True)['ema_params']
  moved = _parts(state.params, 'mu')
  assert all(not torch.equal(moved[n], w) for n, w in start.items())
  meta = os.path.join(workdir, 'checkpoints-meta', 'checkpoint')
  assert torch.load(meta, weights_only=True)['step'] == 5
  assert sorted(os.listdir(os.path.join(workdir, 'checkpoints'))) == [
      'checkpoint_1', 'checkpoint_2']

  # The second call restores the preemption checkpoint (after step 4),
  # not the PINN snapshot, and runs steps 5 and 6.
  history = []
  resumed = pinn_lib.train_bpinn(_config(n_bpinn_iters=6), workdir,
                                 _snapshot(run_dir), device='cpu',
                                 history=history)
  assert [h['step'] for h in history] == [5, 6]
  assert resumed.step == 7
  assert {s.count for s in resumed.opt_state.values()} == {7}


def _bpinn_state(config, fill):
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.05,
                                      is_bpinn=True)
  _, init = pinn_lib.init_pinn(config, device='cpu')
  posterior = bayes.flatten_posterior(bayes.make_bpinn_params(
      init, config, pretrained=False))
  return state_lib.create_train_state(
      {k: torch.full_like(v, fill) for k, v in posterior.items()}, tx,
      config.model.ema_rate)


def test_restore_bpinn_checkpoint_takes_each_branch(run_dir, tmp_path):
  config = _config()
  meta = str(tmp_path / 'meta')
  snapshot = _snapshot(run_dir)
  # Neither checkpoint: the state as given.
  state = _bpinn_state(config, 0.25)
  assert ckpt_lib.restore_bpinn_checkpoint(None, meta, state, config) is state
  same = ckpt_lib.restore_bpinn_checkpoint(str(tmp_path / 'no'), meta,
                                           state, config)
  assert all(bool((v == 0.25).all()) for v in same.params.values())
  # The PINN checkpoint alone: MOPED around its EMA, params and EMA.
  moped = ckpt_lib.restore_bpinn_checkpoint(snapshot, meta,
                                            _bpinn_state(config, 0.25),
                                            config)
  saved = torch.load(snapshot, weights_only=True)['ema_params']
  want = bayes.flatten_posterior(bayes.make_bpinn_params(
      bayes.by_key(saved), config, pretrained=True))
  for tree in (moped.params, moped.ema_params):
    assert all(torch.equal(tree[k], v) for k, v in want.items())
  assert moped.step == 0
  # The B-PINN meta checkpoint is preferred to the PINN checkpoint.
  written = _bpinn_state(config, 0.5)
  written.step = 9
  ckpt_lib.save_checkpoint(meta, written)
  restored = ckpt_lib.restore_bpinn_checkpoint(snapshot, meta,
                                               _bpinn_state(config, 0.25),
                                               config)
  assert restored.step == 9
  assert all(bool((v == 0.5).all()) for v in restored.params.values())


def test_ukf_run_filters_with_the_trained_posterior(run_dir, data_dir,
                                                    tmp_path, monkeypatch):
  """``run(ckptdir=<a B-PINN snapshot>)`` filters with that state's
  ``ema_params``, and equals a run handed the same posterior; without
  ``ckptdir`` the posterior is the seed-0 init's with the priors' rho."""
  config = _config(n_bpinn_iters=2)
  bpinn_dir = tmp_path / 'bpinn'
  pinn_lib.train_bpinn(config, str(bpinn_dir), _snapshot(run_dir),
                       device='cpu')
  ckpt = str(bpinn_dir / 'checkpoints' / 'checkpoint_1')
  ema = torch.load(ckpt, weights_only=True)['ema_params']
  handed = []
  real_kf = ukf_lib.PINN_KF

  def spy(config, model, bparams):
    handed.append(bparams)
    return real_kf(config, model, bparams)

  monkeypatch.setattr(ukf_lib, 'PINN_KF', spy)
  restored = ukf_lib.run(config, str(tmp_path / 'ckpt'), n_steps=2,
                         device='cpu', ckptdir=ckpt)
  got = bayes.flatten_posterior(handed[-1])
  assert got.keys() == ema.keys()
  assert all(torch.equal(got[k], v) for k, v in ema.items())
  png = (tmp_path / 'ckpt' / 'ukf.png').read_bytes()
  assert png.startswith(PNG_SIGNATURE)

  monkeypatch.setattr(ukf_lib.bayes, 'make_bpinn_params',
                      lambda *args, **kwargs: bayes.nest_posterior(ema))
  assert ukf_lib.run(config, str(tmp_path / 'handed'), n_steps=2,
                     device='cpu') == restored
  monkeypatch.undo()
  monkeypatch.setattr(ukf_lib, 'PINN_KF', spy)

  plain = ukf_lib.run(config, str(tmp_path / 'plain'), n_steps=2,
                      device='cpu')
  _, init = pinn_lib.init_pinn(config, seed=0, device='cpu')
  want = bayes.flatten_posterior(bayes.make_bpinn_params(
      init, config, pretrained=False))
  got = bayes.flatten_posterior(handed[-1])
  assert all(torch.equal(got[k], v) for k, v in want.items())
  assert np.isfinite(plain) and plain != restored
