"""The training loop on the CPU (``TINY_DDPM``, f32):
``run_lib.train`` with every cadence event and a resume from the
preemption checkpoint, checkpoints, and dropout from an explicit
generator."""

import os

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.models import layers, registry
from b_pinn_kalman_filter_tpu_torch.train import checkpoint, run_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401


def test_dropout_draws_from_the_generator():
  """flax ``nn.Dropout`` semantics: kept elements scaled by 1/(1-p), the
  mask a function of the generator alone; eval ignores it."""
  x = torch.ones((64, 64))
  y = layers.dropout(x, 0.25, torch.Generator().manual_seed(0))
  kept = y != 0
  assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
  assert 0.7 < float(kept.float().mean()) < 0.8
  assert torch.equal(y, layers.dropout(x, 0.25,
                                       torch.Generator().manual_seed(0)))
  assert torch.equal(layers.dropout(x, 0.0, None), x)
  with pytest.raises(ValueError, match='Generator'):
    layers.dropout(x, 0.25, None)

  _, torch_config = port_parity.tiny_configs()
  torch_config.model.dropout = 0.5
  model = registry.create_model(torch_config, device='cpu', seed=1)
  rng = np.random.default_rng(4)
  x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32))
  labels = torch.tensor([5.0, 500.0])
  with torch.no_grad():
    a = model(x, labels, train=True, generator=torch.Generator().manual_seed(1))
    b = model(x, labels, train=True, generator=torch.Generator().manual_seed(1))
    c = model(x, labels, train=True, generator=torch.Generator().manual_seed(2))
    e1 = model(x, labels, train=False)
    e2 = model(x, labels, train=False, generator=torch.Generator())
  assert torch.equal(a, b) and not torch.equal(a, c)
  assert torch.equal(e1, e2) and not torch.equal(a, e1)


def _loop_config():
  _, config = port_parity.tiny_configs()
  t = config.training
  t.batch_size, t.n_iters = 8, 4
  t.log_freq, t.eval_freq = 1, 2
  t.snapshot_freq_for_preemption, t.snapshot_freq = 2, 4
  config.optim.warmup = 2
  return config


def test_train_loop_fires_every_event_and_resumes(tmp_path):
  """``run_lib.train`` on the CPU for steps 0..4: the log at every step,
  eval at 0, 2, 4, the preemption checkpoint at 2 and 4, the snapshot at
  4 with N = 4 samples under the EMA; the meta checkpoint holds the final
  state; a second call resumes at step 5 and runs to the new n_iters."""
  config = _loop_config()
  history = []
  state = run_lib.train(config, str(tmp_path), device='cpu',
                        history=history)
  assert [h['step'] for h in history] == [0, 1, 2, 3, 4]
  assert [h['events'] for h in history] == [
      ['log', 'eval'], ['log'], ['log', 'preempt_ckpt', 'eval'], ['log'],
      ['log', 'preempt_ckpt', 'eval', 'snapshot']]
  assert all(np.isfinite(h['loss']) for h in history)
  assert state.step == 5 and state.opt_state.count == 5
  assert os.listdir(tmp_path / 'checkpoints') == ['checkpoint_1']
  samples = np.load(tmp_path / 'samples' / 'iter_4' / 'sample.np')
  assert samples.shape == (2, 8, 8, 3) and samples.dtype == np.uint8
  assert checkpoint.latest_checkpoint_step(str(tmp_path / 'checkpoints')) == 1

  template_model = registry.create_model(config, device='cpu', seed=9)
  tx = losses.get_optimizer(config)
  template = state_lib.create_train_state(
      dict(template_model.named_parameters()), tx, config.model.ema_rate)
  restored = checkpoint.restore_checkpoint(
      str(tmp_path / 'checkpoints-meta' / 'checkpoint'), template)
  assert restored.step == 5 and restored.opt_state.count == 5
  for got, want in ((restored.params, state.params),
                    (restored.opt_state.mu, state.opt_state.mu),
                    (restored.opt_state.nu, state.opt_state.nu),
                    (restored.ema_params, state.ema_params)):
    assert all(torch.equal(got[k], want[k]) for k in want)

  config.training.n_iters = 6
  history = []
  resumed = run_lib.train(config, str(tmp_path), device='cpu',
                          history=history)
  assert [h['step'] for h in history] == [5, 6]
  assert resumed.step == 7


def test_restore_refuses_another_model(tmp_path):
  config = _loop_config()
  model = registry.create_model(config, device='cpu', seed=0)
  tx = losses.get_optimizer(config)
  state = state_lib.create_train_state(dict(model.named_parameters()), tx,
                                       0.999)
  path = str(tmp_path / 'ckpt')
  assert checkpoint.restore_checkpoint(path, state, quiet=True) is state
  checkpoint.save_checkpoint(path, state)
  config.model.nf = 64
  other = registry.create_model(config, device='cpu', seed=0)
  template = state_lib.create_train_state(dict(other.named_parameters()), tx,
                                          0.999)
  with pytest.raises(ValueError, match='shape'):
    checkpoint.restore_checkpoint(path, template)
