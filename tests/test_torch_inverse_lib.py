"""The port's ``inverse`` entry point against the JAX package's.

Limit: 1e-4 relative to max |JAX| (f32).  The NC data are a small
``.nc.npz`` under a temporary data directory (the synthetic stand-in is
512 x 456 x 256, too large for a unit test)."""

import os

import jax
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.inverse import inverse_lib as jax_inverse_lib
from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.data import datasets
from b_pinn_kalman_filter_tpu_torch.inverse import inverse_lib
from b_pinn_kalman_filter_tpu_torch.inverse import operators
from b_pinn_kalman_filter_tpu_torch.models import registry
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from b_pinn_kalman_filter_tpu_torch.utils.misc import PNG_SIGNATURE
from tests import inverse_parity as ip
from tests.port_parity import _rel
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
NC_FILE = 'bsose_i122_2013to2017_1day_Theta.nc.npz'


@pytest.fixture
def nc_data(tmp_path, monkeypatch):
  """A 30-frame 16x12 field as the NC file's ``.npz`` sibling."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  os.makedirs(tmp_path / 'data')
  field = datasets.smooth_field(np.random.default_rng(0), (30, 1, 16, 12), 4)
  np.savez(tmp_path / 'data' / NC_FILE, THETA=field.astype(np.float32))
  return tmp_path


def _lib_configs():
  j_config, p_config = ip.mlp_configs()
  for config in (j_config, p_config):
    config.data.land_cut = 4
    config.inverse.solver, config.inverse.dpm_steps = 'dpm', 3
  return j_config, p_config


def test_inverse_fn_matches_jax(nc_data):
  """The first test batch observed through the first mask of the
  ``inpaint`` stream and sampled by DPS (``dpm``, 3 steps): origin,
  observation and sample as JAX's ``_inverse_fn``'s, JAX's draws fed in."""
  j_config, p_config = _lib_configs()
  j_model, params = ip.jax_model(j_config)
  rng = jax.random.PRNGKey(11)
  j_origin, j_obs, j_sample, _ = jax_inverse_lib._inverse_fn(
      j_config, j_model, params, rng)
  z, obs_noise, _ = ip.jax_draws(rng, ip.SHAPE, (2, 1, 16))
  origin, obs, sample, operator = inverse_lib._inverse_fn(
      p_config, ip.torch_model(p_config, params), None, None, 'cpu', z=z,
      obs_noise=obs_noise)
  np.testing.assert_array_equal(origin.numpy(), np.asarray(j_origin))
  np.testing.assert_array_equal(obs.numpy(), np.asarray(j_obs))
  assert _rel(sample.numpy(), j_sample) <= TOL
  assert isinstance(operator, operators.InpaintOperator)
  mse = inverse_lib.evaluate_inverse(p_config, origin, sample, operator)
  want = jax_inverse_lib.evaluate_inverse(j_config, j_origin, j_sample, None)
  assert abs(mse - want) <= TOL * want


def test_inverse_writes_its_outputs_from_a_checkpoint(nc_data):
  """``inverse`` on the CPU from a port checkpoint: the sample is
  ``_inverse_fn``'s under the checkpoint's EMA parameters, and
  ``inverse.png``, ``observation.png`` and ``mse.txt`` are written under
  ``<workdir>/inpaint-0.5``."""
  _, config = _lib_configs()
  model = registry.create_model(config, device='cpu')
  state = state_lib.create_train_state(dict(model.named_parameters()),
                                       losses.get_optimizer(config),
                                       config.model.ema_rate)
  with torch.no_grad():
    for i, v in enumerate(state.ema_params.values()):
      v.copy_(torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
              / v.shape[0] ** 0.5)
  ckpt = str(nc_data / 'ckpt')
  ckpt_lib.save_checkpoint(ckpt, state)
  info = {}
  origin, obs, sample, mse = inverse_lib.inverse(
      config, ckpt, str(nc_data / 'work'), device='cpu', info=info)
  want = inverse_lib._inverse_fn(
      config, model, state.ema_params,
      torch.Generator().manual_seed(config.seed), 'cpu')[2]
  torch.testing.assert_close(sample, want)
  assert info == {'nfe': 4} and np.isfinite(mse)
  outdir = nc_data / 'work' / 'inpaint-0.5'
  for name in ('inverse.png', 'observation.png'):
    assert (outdir / name).read_bytes()[:8] == PNG_SIGNATURE
  assert float((outdir / 'mse.txt').read_text()) == mse
  assert mse == float(torch.mean((origin - sample) ** 2))

