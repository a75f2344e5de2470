"""NCSN++ in the port alone, on the CPU (no JAX): ``run_lib.train`` at
the tiny VE variant (``tests/port_parity.py`` ``TINY_NCSNPP``) with a
snapshot, and a ``run_lib.sample`` request by the config's PC sampler
(reverse diffusion and Langevin: 2 N evaluations); the forward of every
NCSN++ config at 32x32 and a tiny width (the high-resolution pyramids on
their own dataset stand-ins' shapes); ``tpu.remat`` with both resblock
types."""

import os

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.data import datasets
from b_pinn_kalman_filter_tpu_torch.models import ncsnpp, registry
from b_pinn_kalman_filter_tpu_torch.train import run_lib
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

NCSNPP_CONFIGS = [
    've/cifar10_ncsnpp', 've/cifar10_ncsnpp_continuous',
    've/cifar10_ncsnpp_deep_continuous', 'vp/cifar10_ncsnpp',
    'vp/cifar10_ncsnpp_continuous', 'vp/cifar10_ncsnpp_deep_continuous',
    'subvp/cifar10_ncsnpp_continuous', 'subvp/cifar10_ncsnpp_deep_continuous',
    've/celeba_ncsnpp', 've/celebahq_ncsnpp_continuous',
    've/celebahq_256_ncsnpp_continuous', 've/ffhq_ncsnpp_continuous',
    've/ffhq_256_ncsnpp_continuous', 've/church_ncsnpp_continuous',
    've/bedroom_ncsnpp_continuous']


def test_train_and_sample_at_the_tiny_ve_variant(tmp_path, monkeypatch):
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  _, config = port_parity.tiny_ncsnpp_configs('ve')
  t = config.training
  t.n_iters, t.batch_size = 1, 8     # snapshots of batch_size // 4
  t.log_freq = t.eval_freq = t.snapshot_freq_for_preemption = 1
  t.snapshot_freq = 1
  config.model.num_scales = 2
  history = []
  state = run_lib.train(config, str(tmp_path), device='cpu',
                        history=history)
  assert [h['step'] for h in history] == [0, 1]
  assert all(np.isfinite(h['loss']) for h in history)
  assert 'snapshot' in history[-1]['events'] and state.step == 2
  samples = np.load(tmp_path / 'samples' / 'iter_1' / 'sample.np')
  assert samples.shape == (2, 16, 16, 1)
  assert os.listdir(tmp_path / 'checkpoints') == ['checkpoint_1']

  config.model.num_scales = 3
  samples, nfe = run_lib.sample(config, batch_size=2, seed=1, device='cpu')
  assert nfe == 2 * 3
  assert samples.shape == (2, 16, 16, 1) and torch.isfinite(samples).all()


@pytest.mark.parametrize('name', NCSNPP_CONFIGS)
def test_every_ncsnpp_config_builds_and_runs_its_forward(name):
  """Each config at nf 8 (16 for the 1024^2 ones, whose widths nf *
  ch_mult reach 32 nf) and 32x32, its levels cut to fit: finite scores of
  the input's shape, its batch from its dataset stand-in."""
  config = configs.get_config(name)
  m = config.model
  levels = len(m.ch_mult)
  m.nf, config.data.image_size = 8, 32
  m.ch_mult = tuple(m.ch_mult[:min(levels, 3)])
  m.num_res_blocks = 1
  config.tpu.compute_dtype = 'float32'
  config.training.batch_size = 2
  model = registry.create_model(config, device='cpu', seed=0)
  assert isinstance(model, ncsnpp.NCSNpp)
  batch, _ = next(iter(datasets.get_dataset(config)[0]))
  x = torch.from_numpy(np.asarray(batch))
  assert x.shape == (2, 32, 32, 3)
  if m.embedding_type == 'fourier':
    labels = torch.tensor([0.5, float(m.sigma_max)])
  else:
    labels = torch.tensor([3.0, 900.0])
  with torch.no_grad():
    out = model(x, labels, train=False)
  assert out.shape == x.shape and torch.isfinite(out).all()


@pytest.mark.parametrize('variant', ['ve', 'ddpm'])
def test_remat_is_refused(variant):
  """``tpu.remat`` at the tiny NCSN++ with BigGAN ('ve') and DDPM++
  ('ddpm') resblocks, dropout 0.1 in training: the loss and every
  gradient bit for bit as without it, the same names, the generator left
  where it was, each resblock recomputed in the backward
  (``port_parity.check_remat``)."""
  _, config = port_parity.tiny_ncsnpp_configs(variant)
  runs = port_parity.check_remat(config)
  blocks = {'ve': 'ResnetBlockBigGANpp', 'ddpm': 'ResnetBlockDDPMpp'}
  assert any(k.startswith(blocks[variant]) for k in runs[True][2])
