"""The port's discrete score-matching step, port only (CPU,
``TINY_DDPM``): ``get_step_fn(continuous=False)`` steps through the loss
its SDE selects (SMLD for VE, DDPM for VP) and refuses what the JAX step
refuses; ``--mode train`` on ``vp/nc_ddpmpp`` (which trains by the DDPM
loss) runs on the CPU.  The losses against JAX:
tests/test_torch_discrete_losses.py."""

import os

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch import __main__ as cli
from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data import datasets
from b_pinn_kalman_filter_tpu_torch.models import ddpm, layers
from b_pinn_kalman_filter_tpu_torch.train import run_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(sde_name):
  """The port's tiny flagship config on ``sde_name``, dropout 0."""
  config = port_parity.tiny_configs()[1]
  config.training.sde = sde_name
  config.model.dropout = 0.0
  return config


@pytest.mark.parametrize('sde_name, want', [('vpsde', 'ddpm'),
                                            ('vesde', 'smld')])
def test_discrete_step_takes_the_loss_of_its_sde(sde_name, want):
  """``get_step_fn(continuous=False)`` steps through the loss its SDE
  selects: the step's loss under the same draws is that loss's, the
  parameters moved, the step counted; drawn by a generator, the labels
  lie in [0, N)."""
  config = _config(sde_name)
  config.optim.warmup = 0
  model = ddpm.DDPM(config).eval()
  layers.init_params(model, torch.Generator().manual_seed(0))
  sde, _ = sde_lib.get_sde(config)
  tx = losses.get_optimizer(config)
  state = state_lib.create_train_state(dict(model.named_parameters()), tx,
                                       config.model.ema_rate)
  batch = torch.from_numpy(port_parity.train_batch(2))
  noise = (torch.tensor([0, 3, 1, 2]), torch.randn(
      batch.shape, generator=torch.Generator().manual_seed(1)))
  loss_fn = {'ddpm': losses.get_ddpm_loss_fn,
             'smld': losses.get_smld_loss_fn}[want](
                 sde, model, True, reduce_mean=config.training.reduce_mean)
  with torch.no_grad():
    want_loss = loss_fn(state.params, batch, noise=noise)
  before = {k: v.clone() for k, v in state.params.items()}
  step_fn = losses.get_step_fn(sde, model, tx, train=True,
                               reduce_mean=config.training.reduce_mean,
                               continuous=False)
  state, loss = step_fn(state, batch, noise=noise)
  assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
  assert state.step == 1
  assert any(not torch.equal(before[k], v) for k, v in state.params.items())
  labels, _ = losses._labels_and_noise(
      sde.N, torch.zeros(256, 1), torch.Generator().manual_seed(3), None)
  assert int(labels.min()) == 0 and int(labels.max()) == sde.N - 1
  eval_fn = losses.get_step_fn(sde, model, tx, train=False,
                               reduce_mean=config.training.reduce_mean,
                               continuous=False)
  _, eval_loss = eval_fn(state, batch, generator=torch.Generator())
  assert np.isfinite(float(eval_loss))


def test_discrete_step_refuses_what_jax_refuses():
  """Likelihood weighting, and an SDE other than VE or VP, as in JAX;
  each discrete loss takes only its own SDE."""
  config = _config('vpsde')
  model = ddpm.DDPM(config).eval()
  tx = losses.get_optimizer(config)
  vp, _ = sde_lib.get_sde(config)
  with pytest.raises(ValueError, match='Likelihood weighting'):
    losses.get_step_fn(vp, model, tx, train=True, continuous=False,
                       likelihood_weighting=True)
  sub = sde_lib.subVPSDE(N=4)
  with pytest.raises(ValueError, match='subVPSDE'):
    losses.get_step_fn(sub, model, tx, train=True, continuous=False)
  with pytest.raises(ValueError, match='VESDE'):
    losses.get_smld_loss_fn(vp, model, True)
  with pytest.raises(ValueError, match='VPSDE'):
    losses.get_ddpm_loss_fn(sde_lib.VESDE(N=4), model, True)


def test_train_mode_on_nc_ddpmpp_runs_on_the_cpu(tmp_path, monkeypatch):
  """``--mode train --config vp/nc_ddpmpp --device cpu`` cut to a tiny
  U-Net at 8x8, batch 2, over a small NC file: the DDPM loss trains (a
  finite loss each step) and the last snapshot is written."""
  data = tmp_path / 'data'
  data.mkdir()
  field = datasets.smooth_field(np.random.default_rng(0), (12, 1, 12, 10), 4)
  np.savez(data / 'bsose_i122_2013to2017_1day_Theta.nc.npz',
           THETA=field.astype(np.float32))
  monkeypatch.setenv('BPKF_DATA_DIR', str(data))
  workdir = tmp_path / 'nc'
  config = os.path.join(ROOT, 'b_pinn_kalman_filter_tpu_torch', 'configs',
                        'vp', 'nc_ddpmpp.py')
  history = []
  real_train = run_lib.train
  monkeypatch.setattr(run_lib, 'train', lambda *a, **k: real_train(
      *a, history=history, **k))
  cli.main(['--config', config, '--workdir', str(workdir), '--mode',
            'train', '--device', 'cpu', '--config.data.image_size=8',
            '--config.data.land_cut=2', '--config.model.nf=32',
            '--config.model.ch_mult=(1, 2)', '--config.model.num_res_blocks=1',
            '--config.model.attn_resolutions=(4,)',
            '--config.training.batch_size=2', '--config.training.n_iters=2',
            '--config.training.snapshot_sampling=False',
            '--config.tpu.compute_dtype=float32'])
  assert [h['step'] for h in history] == [0, 1, 2]
  assert all(np.isfinite(h['loss']) for h in history)
  # The last step's snapshot: checkpoint_{2 // snapshot_freq}.
  assert (workdir / 'checkpoints' / 'checkpoint_0').is_file()
