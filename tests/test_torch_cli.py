"""The port's command line, ``python -m b_pinn_kalman_filter_tpu_torch``:
the config file and its overrides, each mode's entry point, ``--mode
sample`` and ``--mode eval`` on the CPU, and one ``--mode simulate`` and
one ``--mode inverse`` run on the CPU in a subprocess."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from b_pinn_kalman_filter_tpu_torch import __main__ as cli
from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.data import datasets
from b_pinn_kalman_filter_tpu_torch.inverse import inverse_lib
from b_pinn_kalman_filter_tpu_torch.kalman import simulator, ukf_lib
from b_pinn_kalman_filter_tpu_torch.pinn import pinn_lib
from b_pinn_kalman_filter_tpu_torch.train import run_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINN_CONFIG = os.path.join(ROOT, 'b_pinn_kalman_filter_tpu_torch', 'configs',
                           'pinn', 'pinn_pde.py')
DPS_CONFIG = os.path.join(ROOT, 'b_pinn_kalman_filter_tpu_torch', 'configs',
                          'inverse', 'nc_ddpmpp_inpaint_dps.py')
FLAGSHIP_CONFIG = os.path.join(ROOT, 'b_pinn_kalman_filter_tpu_torch',
                               'configs', 'vp', 'cifar10_ddpmpp_continuous.py')


def test_config_file_and_overrides():
  args, overrides = cli.parse_args([
      '--config', PINN_CONFIG, '--workdir', 'w', '--mode', 'ukf',
      '--config.training.n_iters=5', '--config.optim.lr=1e-3',
      '--config.model.feature_nums=(4, 8)', '--config.data.dataset=PDE'])
  assert (args.mode, args.device, args.ckptdir) == ('ukf', 'cuda', None)
  config = cli.load_config(args.config)
  assert config == configs.get_config('pinn/pinn_pde')
  cli.apply_overrides(config, overrides)
  assert config.training.n_iters == 5
  assert config.optim.lr == 1e-3
  assert config.model.feature_nums == (4, 8)
  assert config.data.dataset == 'PDE'
  for wrong in ('training.n_iter=5', 'nothing.n_iters=5', 'seed.x=1',
                'training.n_iters'):
    with pytest.raises(ValueError):
      cli.apply_overrides(config, [wrong])
  with pytest.raises(SystemExit):
    cli.parse_args(['--config', PINN_CONFIG, '--workdir', 'w', '--mode',
                    'ukf', '--stray=1'])


@pytest.mark.parametrize('mode, module, name', [
    ('train', run_lib, 'train'),
    ('train_pinn', pinn_lib, 'train'),
    ('train_bpinn', pinn_lib, 'train_bpinn'),
    ('simulate', simulator, 'run'),
    ('ukf', ukf_lib, 'run'),
    ('inverse', inverse_lib, 'inverse'),
    ('sample', run_lib, 'sample_from_checkpoint'),
    ('eval', run_lib, 'evaluate'),
])
def test_each_mode_calls_its_entry_point(tmp_path, monkeypatch, mode, module,
                                         name):
  """The mode's entry point gets the config with its overrides, the
  workdir, the checkpoint and the device; the training modes log to
  ``stdout.txt``."""
  calls = []

  def entry(*args, **kwargs):
    calls.append((args, kwargs))
    logging.getLogger('b_pinn_kalman_filter_tpu_torch.test').info('ran')

  monkeypatch.setattr(module, name, entry)
  workdir = str(tmp_path / 'work')
  assert cli.main(['--config', PINN_CONFIG, '--workdir', workdir, '--mode',
                   mode, '--ckptdir', 'ck', '--device', 'cpu',
                   '--config.training.n_iters=3']) == 0
  (args, kwargs), = calls
  config = args[0]
  assert config.training.n_iters == 3
  assert kwargs['device'] == 'cpu'
  positional = args[1:] + ((kwargs['ckptdir'],) if mode == 'ukf' else ())
  want = {'train': (workdir,), 'train_pinn': (workdir,),
          'train_bpinn': (workdir, 'ck'), 'simulate': ('ck', workdir),
          'ukf': (workdir, 'ck'), 'inverse': ('ck', workdir),
          'sample': ('ck', workdir), 'eval': (workdir, 'eval')}[mode]
  assert positional == want
  stdout = os.path.join(workdir, 'stdout.txt')
  if mode.startswith('train'):
    with open(stdout) as fh:
      assert 'ran' in fh.read()
  else:
    assert not os.path.exists(stdout)


@pytest.fixture(scope='module')
def flagship_run(tmp_path_factory):
  """The flagship config cut to the MLP score model at 4x4 (its overrides
  as the CLI takes them), and a workdir holding ``checkpoint_1`` of a
  two-step ``run_lib.train``."""
  overrides = ['--config.model.name=mlp', '--config.model.scale_by_sigma=False',
               '--config.data.image_size=4', '--config.model.num_scales=3',
               '--config.tpu.compute_dtype=float32',
               '--config.training.batch_size=4', '--config.training.n_iters=2',
               '--config.training.snapshot_freq=2',
               '--config.training.snapshot_sampling=False',
               '--config.sampling.corrector=none',
               '--config.eval.begin_ckpt=1', '--config.eval.end_ckpt=1',
               '--config.eval.batch_size=256']
  config = cli.load_config(FLAGSHIP_CONFIG)
  cli.apply_overrides(config, [o[len(cli.OVERRIDE):] for o in overrides])
  workdir = tmp_path_factory.mktemp('flagship')
  run_lib.train(config, str(workdir), device='cpu')
  return workdir, overrides


@pytest.mark.parametrize('mode', ['sample', 'eval'])
def test_sample_and_eval_modes_run_on_the_cpu(flagship_run, tmp_path, mode):
  """``--mode sample --ckptdir <checkpoint>`` writes ``sample.png``;
  ``--mode eval --eval_folder <name>`` writes the eval loss of the
  checkpoints under ``<workdir>/checkpoints`` (two batches of 256 of the
  synthetic eval split)."""
  workdir, overrides = flagship_run
  ckpt = str(workdir / 'checkpoints' / 'checkpoint_1')
  out = tmp_path / 'out' if mode == 'sample' else workdir
  extra = (['--ckptdir', ckpt] if mode == 'sample'
           else ['--eval_folder', 'cli_eval'])
  assert cli.main(['--config', FLAGSHIP_CONFIG, '--workdir', str(out),
                   '--mode', mode, '--device', 'cpu', *extra,
                   *overrides]) == 0
  if mode == 'sample':
    assert (out / 'sample.png').read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
  else:
    loss = np.load(out / 'cli_eval' / 'ckpt_1_loss.npz')
    assert loss['all_losses'].shape == (2,)
    assert np.isfinite(float(loss['mean_loss']))


def test_simulate_mode_runs_on_the_cpu(tmp_path):
  """``python -m b_pinn_kalman_filter_tpu_torch --mode simulate --device
  cpu`` at 16x16 writes finite MSEs and its PNG."""
  workdir = tmp_path / 'sim'
  env = dict(os.environ, BPKF_DATA_DIR=str(tmp_path / 'data'))
  subprocess.run(
      [sys.executable, '-m', 'b_pinn_kalman_filter_tpu_torch', '--config',
       PINN_CONFIG, '--workdir', str(workdir), '--mode', 'simulate',
       '--device', 'cpu', '--config.data.image_size=16'],
      cwd=ROOT, env=env, check=True, timeout=300)
  mses = np.loadtxt(workdir / 'simulate_mse.txt')
  assert mses.shape == (100,) and np.isfinite(mses).all()
  assert (workdir / 'simulate.png').read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'


def test_inverse_mode_runs_on_the_cpu(tmp_path):
  """``--mode inverse --device cpu`` on ``inverse/nc_ddpmpp_inpaint_dps``
  cut to the MLP score model at 4x4, batch 2, DPS by ``dpm`` in 2 steps,
  over a small NC file: the two PNGs and a finite ``mse.txt``."""
  data = tmp_path / 'data'
  data.mkdir()
  field = datasets.smooth_field(np.random.default_rng(0), (30, 1, 16, 12), 4)
  np.savez(data / 'bsose_i122_2013to2017_1day_Theta.nc.npz',
           THETA=field.astype(np.float32))
  workdir = tmp_path / 'inv'
  subprocess.run(
      [sys.executable, '-m', 'b_pinn_kalman_filter_tpu_torch', '--config',
       DPS_CONFIG, '--workdir', str(workdir), '--mode', 'inverse',
       '--device', 'cpu', '--config.model.name=mlp',
       '--config.data.image_size=4', '--config.data.land_cut=4',
       '--config.training.batch_size=2', '--config.inverse.solver=dpm',
       '--config.inverse.dpm_steps=2'],
      cwd=ROOT, env=dict(os.environ, BPKF_DATA_DIR=str(data)), check=True,
      timeout=300)
  out = workdir / 'inpaint-0.5'
  for name in ('inverse.png', 'observation.png'):
    assert (out / name).read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
  assert np.isfinite(float((out / 'mse.txt').read_text()))
