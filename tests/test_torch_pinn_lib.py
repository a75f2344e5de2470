"""PINN phase 1's training loop, ``pinn_lib.train_prelim``, on the CPU at tiny
widths (``feature_nums`` (8, 16), 16x16, batch 2) on the synthetic PDE
data: the events at a cut cadence, the checkpoints, and a resume from the
preemption checkpoint.  The step itself against the JAX package:
tests/test_torch_pinn_prelim.py."""

import logging
import os

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.pinn import pinn_lib
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from tests.port_parity import one_torch_thread  # noqa: F401


def _config(n_iters):
  config = configs.get_config('pinn/pinn_pde')
  config.data.image_size = 16
  config.model.feature_nums = (8, 16)
  t = config.training
  t.batch_size = 2
  t.n_iters = n_iters
  t.log_freq = 2
  t.eval_freq = 3
  t.snapshot_freq_for_preemption = 4
  t.snapshot_freq = 5
  return config


def test_train_prelim_fires_every_event_and_resumes(tmp_path, monkeypatch,
                                                    caplog):
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  workdir = str(tmp_path / 'work')
  history = []
  with caplog.at_level(logging.INFO, logger=pinn_lib.__name__):
    state = pinn_lib.train_prelim(_config(6), workdir, device='cpu',
                                  history=history)
  assert [h['step'] for h in history] == list(range(7))
  assert [h['events'] for h in history] == [
      ['log', 'eval'], [], ['log'], ['eval'], ['log', 'preempt_ckpt'],
      ['snapshot'], ['log', 'eval', 'snapshot']]
  assert all(np.isfinite(h['loss']) for h in history)
  messages = [r.getMessage() for r in caplog.records]
  assert sum('prelim_loss' in m and 'eval' not in m for m in messages) == 4
  assert sum('eval_prelim_loss' in m for m in messages) == 3
  assert state.step == 7
  assert set(state.opt_state) == {'flow', 'pres'}
  assert all(s.count == 7 for s in state.opt_state.values())
  assert sorted(os.listdir(os.path.join(workdir, 'checkpoints'))) == [
      'checkpoint_1']
  meta = os.path.join(workdir, 'checkpoints-meta', 'checkpoint')
  saved = torch.load(meta, weights_only=True)
  assert saved['step'] == 5 and saved['opt_state']['pres']['count'] == 5
  assert ckpt_lib.latest_checkpoint_step(
      os.path.join(workdir, 'checkpoints')) == 1

  # The second call restores the preemption checkpoint (after step 4) and
  # runs steps 5 .. 8; the parameters went on moving.
  history = []
  resumed = pinn_lib.train_prelim(_config(8), workdir, device='cpu',
                                  history=history)
  assert [h['step'] for h in history] == [5, 6, 7, 8]
  assert resumed.step == 9
  name = 'pressurenet.Conv_1.kernel'
  assert not torch.equal(resumed.params[name], saved['params'][name])
