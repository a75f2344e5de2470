"""The port's ``eval`` and ``sample`` modes on the CPU (port only; the JAX
side's are tests/test_evaluate_mode.py's): ``run_lib.evaluate`` writes
the files and keys that test checks, waits for a late checkpoint and
skips a missing one; ``sample_from_checkpoint`` restores a checkpoint and
writes ``sample.png``; the finite eval loader yields the JAX package's
batches, drop-last included.

The model is the flagship config's MLP score model at 4x4x3 (the JAX
test's ``tiny_mlp_config`` in kind), so that bits/dim by Dormand–Prince
over the synthetic eval split (512 images, 4 batches of 128) stays
inside the file's time.
"""

import os
import threading

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.data import datasets as jax_datasets
from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.core import sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data import datasets
from b_pinn_kalman_filter_tpu_torch.data.scalers import get_data_inverse_scaler
from b_pinn_kalman_filter_tpu_torch.train import checkpoint, run_lib
from b_pinn_kalman_filter_tpu_torch.utils import profiling
from b_pinn_kalman_filter_tpu_torch.utils.misc import PNG_SIGNATURE
from tests.port_parity import one_torch_thread  # noqa: F401


def _config():
  config = configs.get_config('vp/cifar10_ddpmpp_continuous')
  config.model.name = 'mlp'
  config.model.scale_by_sigma = False
  config.model.num_scales = 5
  config.data.image_size = 4
  config.tpu.compute_dtype = 'float32'
  t = config.training
  t.batch_size, t.n_iters = 8, 2
  t.snapshot_freq, t.snapshot_freq_for_preemption = 2, 100
  t.eval_freq = t.log_freq = 1
  t.snapshot_sampling = False
  config.sampling.method = 'pc'
  config.sampling.predictor = 'euler_maruyama'
  config.sampling.corrector = 'none'
  config.optim.warmup = 2
  ev = config.eval
  ev.begin_ckpt = ev.end_ckpt = 1
  ev.batch_size = 128
  ev.enable_loss = ev.enable_bpd = ev.enable_sampling = True
  ev.bpd_dataset = 'train'     # one repeat
  ev.num_samples = 8
  return config


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
  """A workdir with ``checkpoints/checkpoint_1`` of a two-step run."""
  workdir = str(tmp_path_factory.mktemp('run'))
  config = _config()
  run_lib.train(config, workdir, device='cpu')
  assert os.path.exists(os.path.join(workdir, 'checkpoints', 'checkpoint_1'))
  return workdir


def test_evaluate_writes_loss_bpd_samples_and_metrics(trained, tmp_path,
                                                      monkeypatch):
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  monkeypatch.delenv('BPKF_INCEPTION_WEIGHTS', raising=False)
  monkeypatch.delenv('BPKF_INCEPTION_RANDOM_INIT', raising=False)
  history = []
  results = run_lib.evaluate(_config(), trained, 'eval_a', device='cpu',
                             history=history)
  eval_dir = os.path.join(trained, 'eval_a')
  for key in ('ckpt_1_loss', 'ckpt_1_bpd', 'ckpt_1_fid', 'ckpt_1_kid',
              'ckpt_1_inception_score'):
    assert np.isfinite(results[key]), key
  assert results['feature_source'] == 'random_proxy'
  loss = np.load(os.path.join(eval_dir, 'ckpt_1_loss.npz'))
  assert loss['all_losses'].shape == (4,)       # 512 images, batches of 128
  bpd = np.load(os.path.join(eval_dir, 'train_ckpt_1_bpd.npz'))['bpd']
  assert bpd.shape == (512,) and np.isfinite(bpd).all()
  assert results['ckpt_1_bpd'] == pytest.approx(float(bpd.mean()))
  samples = np.load(os.path.join(eval_dir, 'ckpt_1', 'samples_0.npz'))
  assert samples['samples'].shape == (128, 4, 4, 3)
  assert samples['samples'].dtype == np.uint8
  report = np.load(os.path.join(eval_dir, 'report_1.npz'))
  assert float(report['fid']) == pytest.approx(results['ckpt_1_fid'])
  assert str(report['feature_source']) == 'random_proxy'
  assert os.path.exists(os.path.join(
      eval_dir, 'assets', 'dataset_feats_CIFAR10_4_3_random_proxy_2048.npz'))
  # num_samples // batch_size + 1 sampling rounds, 4 bpd batches.
  kinds = [h['kind'] for h in history]
  assert kinds == ['bpd'] * 4 + ['sample']
  assert all(h['nfe'] > 0 and h['seconds'] > 0 for h in history)


def test_evaluate_waits_for_a_late_checkpoint_and_skips_a_missing_one(
    trained, tmp_path):
  config = _config()
  template, _ = run_lib._template(config, torch.device('cpu'), 0)
  ckpt = os.path.join(trained, 'checkpoints', 'checkpoint_1')
  late = str(tmp_path / 'late')
  timer = threading.Timer(0.5, lambda: os.link(ckpt, late))
  timer.start()
  try:
    state = run_lib._wait_and_restore(late, template, wait=True,
                                      poll_seconds=0.1)
  finally:
    timer.cancel()
    timer.join(5)
  assert not timer.is_alive()
  assert state is not None and state.step == 3
  assert run_lib._wait_and_restore(late + '_nope', template,
                                   wait=False) is None
  # A checkpoint that cannot be read is retried, then its error raised.
  bad = tmp_path / 'bad'
  bad.write_bytes(b'not a checkpoint')
  with pytest.raises(Exception):
    run_lib._wait_and_restore(str(bad), template, wait=True,
                              poll_seconds=0.01, retries=1)
  # evaluate skips checkpoint_2..3, which are absent, and writes no
  # result (the reference set's features are cached before the loop).
  config.eval.begin_ckpt, config.eval.end_ckpt = 2, 3
  assert run_lib.evaluate(config, trained, 'eval_b', device='cpu') == {}
  assert os.listdir(os.path.join(trained, 'eval_b')) == ['assets']


def test_sample_from_checkpoint_writes_the_grid(trained, tmp_path):
  config = _config()
  ckpt = os.path.join(trained, 'checkpoints', 'checkpoint_1')
  samples, nfe = run_lib.sample_from_checkpoint(config, ckpt,
                                                str(tmp_path / 'out'),
                                                device='cpu')
  assert samples.shape == (8, 4, 4, 3) and torch.isfinite(samples).all()
  assert nfe == 5 * (config.sampling.n_steps_each + 1)   # N (n_steps + 1)
  with open(tmp_path / 'out' / 'sample.png', 'rb') as f:
    assert f.read(8) == PNG_SIGNATURE
  # The samples are those of the checkpoint's EMA parameters.
  template, model = run_lib._template(config, torch.device('cpu'),
                                      config.seed)
  state = checkpoint.restore_checkpoint(ckpt, template)
  again = run_lib.sample(config, batch_size=8, device='cpu', model=model)
  assert not torch.equal(again[0], samples)     # the init's parameters
  sde, eps = sde_lib.get_sde(config)
  fn = sampling.get_sampling_fn(config, sde, model, (8, 4, 4, 3),
                                get_data_inverse_scaler(config), eps,
                                device='cpu')
  want, _ = fn(generator=torch.Generator().manual_seed(config.seed),
               params=state.ema_params)
  assert torch.equal(want, samples)


@pytest.mark.parametrize('n,batch', [(20, 8), (5, 8), (16, 8)])
def test_finite_loader_yields_the_jax_batches(n, batch):
  """One epoch, the last partial batch dropped (none at all from fewer
  items than a batch, as the flagship's eval batch of 1024 on the
  512-image stand-in split), the same items as the JAX loader's."""
  ds = datasets.SyntheticImages(n, 4, 3, seed=2)
  jax_ds = jax_datasets.SyntheticImages(n, 4, 3, seed=2)
  got = list(datasets.NumpyLoader(ds, batch, shuffle=True, seed=3,
                                  num_epochs=1))
  want = list(jax_datasets.NumpyLoader(jax_ds, batch, shuffle=True, seed=3,
                                       num_epochs=1))
  assert len(got) == len(want) == n // batch
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g[0], w[0])
  two = list(datasets.NumpyLoader(ds, batch, shuffle=False, num_epochs=2))
  assert len(two) == 2 * (n // batch)
  config = configs.get_config('vp/cifar10_ddpmpp_continuous')
  config.data.image_size = 4
  _, eval_ds = datasets.get_dataset(config, evaluation=True)
  assert eval_ds.batch_size == 1024 and list(eval_ds) == []


def test_profiling_helpers(tmp_path):
  assert not profiling.check_for_nans({'a': torch.ones(2),
                                       'b': {'c': torch.zeros(3)}})
  assert profiling.check_for_nans({'b': {'c': torch.tensor([1.0, np.nan])}})
  held = {}
  with profiling.timed('block', held):
    torch.ones(4).sum()
  assert held['block'] >= 0
  with profiling.trace(str(tmp_path / 'trace')):
    torch.ones(4).sum()
  assert os.listdir(tmp_path / 'trace')
  profiling.enable_nan_debugging(True)
  try:
    assert torch.is_anomaly_enabled()
  finally:
    profiling.enable_nan_debugging(False)
