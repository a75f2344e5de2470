"""The simulators and the image grid: the port's ``kalman/simulator.py``
(``step_rollout`` through K4's plain version, ``simulate`` through the
PINN, the ``simulate`` entry point) and ``utils/misc.py`` (``make_grid``,
the PNG writer) against the JAX package's, on the CPU.  Limits, relative
to max |JAX|: 1e-4 for the rollouts, the PINN frames and the MSEs; the
grid and the PNG's pixels exactly."""

import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.kalman import simulator as jax_simulator
from b_pinn_kalman_filter_tpu.utils import misc as jax_misc
from b_pinn_kalman_filter_tpu_torch.data.ns_rollout import ns_rollout
from b_pinn_kalman_filter_tpu_torch.kalman import simulator
from b_pinn_kalman_filter_tpu_torch.models import convert
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
from b_pinn_kalman_filter_tpu_torch.utils import misc
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4


def _rel(got, want):
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_step_rollout_matches_jax():
  """Ten NS steps at the reference's DT and DX from frame 0 of a 16x16
  rollout, two copies."""
  begin = ns_rollout(3, 16, 16, seed=1, device='cpu')
  got = simulator.step_rollout(begin, t_range=(0, 10), batch=2)
  want = jax_simulator.step_rollout(begin.numpy(), t_range=(0, 10),
                                    batch=2)
  assert len(got[0]) == len(want[0]) == 10
  for i in range(10):
    assert got[0][i].shape == (2, 16, 16)
    assert _rel(got[0][i], want[0][i]) <= TOL
    for g, w in zip(got[1][i], want[1][i]):
      assert _rel(g, w) <= TOL
    assert _rel(got[2][i], want[2][i]) <= TOL


def test_simulate_matches_jax():
  """Three autoregressive PINN frames at ``feature_nums`` (4,), 8x8, under
  randomised parameters converted from the JAX tree, and under the
  module's own parameters loaded from it."""
  jax_config, torch_config = port_parity.tiny_pinn_configs()
  for config in (jax_config, torch_config):
    config.data.image_size = 8
    config.model.feature_nums = (4,)
  params = port_parity.randomized_params(
      port_parity.pinn_param_shapes(jax_config), seed=2)
  begin = ns_rollout(4, 8, 8, seed=2, device='cpu')
  want, want_vel = jax_simulator.simulate(
      port_parity.jax_pinn(jax_config), params, jax_config, begin.numpy(),
      t_range=(0, 3))
  model = PINN(torch_config).eval()
  got, got_vel = simulator.simulate(model, convert.draw_from_jax(params,
                                                                 model),
                                    torch_config, begin, t_range=(0, 3))
  assert len(got) == len(got_vel) == 3
  for g, w, gv, wv in zip(got, want, got_vel, want_vel):
    assert g.shape == (1, 8, 8, 1) and gv.shape == (1, 8, 8, 2)
    assert _rel(g, w) <= TOL and _rel(gv, wv) <= TOL
  convert.params_from_jax(params, model)
  own, _ = simulator.simulate(model, None, torch_config, begin,
                              t_range=(0, 3))
  assert all(torch.equal(a, b) for a, b in zip(own, got))


def test_run_writes_the_mses_of_jax(tmp_path, monkeypatch):
  """The ``simulate`` entry point, 10 steps at 16x16: the per-step MSEs it
  writes against the JAX ``run``'s, and the PNG grid."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  jax_config, torch_config = port_parity.tiny_pinn_configs()
  got = simulator.run(torch_config, None, str(tmp_path / 'port'), n_steps=10,
                      device='cpu')
  want = jax_simulator.run(jax_config, None, str(tmp_path / 'jax'),
                           n_steps=10)
  written = [float(line) for line in
             (tmp_path / 'port' / 'simulate_mse.txt').read_text().split()]
  assert written == got and len(got) == 10
  assert _rel(got, want) <= TOL
  port_png = imageio.imread(tmp_path / 'port' / 'simulate.png')
  jax_png = imageio.imread(tmp_path / 'jax' / 'simulate.png')
  assert port_png.shape == jax_png.shape == (20, 182)
  assert np.abs(port_png.astype(int) - jax_png).max() <= 1


@pytest.mark.parametrize('channels', [1, 3])
def test_grid_and_png_match_jax(tmp_path, channels):
  """``make_grid`` equals JAX's; the port's PNG, read back by ``imageio``,
  equals JAX's ``save_image_grid`` output pixel for pixel (values past
  [0, 1] clipped, the rest truncated to uint8, one channel as gray)."""
  rng = np.random.default_rng(channels)
  images = rng.uniform(-0.2, 1.2, (7, 5, 6, channels)).astype(np.float32)
  np.testing.assert_array_equal(misc.make_grid(images, 3),
                                jax_misc.make_grid(images, 3))
  misc.save_image_grid(images, str(tmp_path / 'port.png'), nrow=3)
  jax_misc.save_image_grid(images, str(tmp_path / 'jax.png'), nrow=3)
  got = imageio.imread(tmp_path / 'port.png')
  want = imageio.imread(tmp_path / 'jax.png')
  assert got.dtype == want.dtype == np.uint8
  assert got.shape == want.shape == ((23, 26) if channels == 1
                                     else (23, 26, channels))
  np.testing.assert_array_equal(got, want)
  with open(tmp_path / 'port.png', 'rb') as fh:
    assert fh.read(8) == misc.PNG_SIGNATURE
  assert os.path.getsize(tmp_path / 'port.png') > 0
