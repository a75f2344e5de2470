"""The training slice: the port's train step against the JAX package's
``losses.get_step_fn`` from one randomised ``TrainState`` under replayed t
and z with the flagship optimizer, its optimizer against optax, and the
EMA (f32, CPU, ``TINY_DDPM``).  The case with weight decay:
tests/test_torch_train_decay.py; the dropout path and the train loop:
tests/test_torch_train_loop.py.  Limits: ``tests/port_parity.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.core import losses as jax_losses
from b_pinn_kalman_filter_tpu.train import state as jax_state
from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from tests import port_parity
from tests.port_parity import MOMENT_TOL, compare_trees
from tests.port_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope='module')
def flagship_side():
  return port_parity.jax_train_side('flagship')


def test_three_train_steps_match_jax(flagship_side):
  port_parity.check_three_train_steps(flagship_side, 'flagship')


@pytest.mark.parametrize('case', list(port_parity.TRAIN_CASES))
def test_optimizer_matches_optax(case):
  """Three updates of the same small tree from the same gradients: the
  updates (params ~ 1e-3, so that their f32 rounding stays far below an
  update of ~lr), mu, nu and the count.  Through the network the updates
  cannot be held this close: Adam divides by sqrt(nu), so an element's
  update carries its gradient's relative error, large where the gradient
  is small."""
  optim, torch_config = port_parity.train_configs(case)
  j_tx = jax_losses.get_optimizer(optim)
  tx = losses.get_optimizer(torch_config)
  rng = np.random.default_rng(5)
  shapes = {'a': (3, 4), 'b': (7,)}
  params = {k: (1e-3 * rng.standard_normal(v)).astype(np.float32)
            for k, v in shapes.items()}
  j_params = {k: jnp.asarray(v) for k, v in params.items()}
  j_opt = j_tx.init(j_params)
  p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
  p_opt = tx.init(p_params)
  for step in range(3):
    grads = {k: rng.standard_normal(v).astype(np.float32)
             for k, v in shapes.items()}
    updates, j_opt = j_tx.update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, j_opt, j_params)
    before = {k: v.clone() for k, v in p_params.items()}
    tx.apply_([torch.from_numpy(grads[k]) for k in shapes], p_opt, p_params)
    j_params = {k: j_params[k] + updates[k] for k in shapes}
    adam = j_opt[-1][0]
    assert p_opt.count == int(adam.count) == step + 1
    if step == 0:
      assert not any(np.asarray(u).any() for u in updates.values())
      assert all(torch.equal(p_params[k], before[k]) for k in shapes)
    else:
      compare_trees({k: (p_params[k] - before[k]).numpy() for k in shapes},
                    updates, MOMENT_TOL, f'update {step}')
    compare_trees({k: v.numpy() for k, v in p_params.items()}, j_params,
                  MOMENT_TOL, f'params {step}')
    compare_trees({k: v.numpy() for k, v in p_opt.mu.items()}, adam.mu,
                  MOMENT_TOL, f'mu {step}')
    compare_trees({k: v.numpy() for k, v in p_opt.nu.items()}, adam.nu,
                  MOMENT_TOL, f'nu {step}')


def test_ema_decay_reads_the_step_before_its_increment():
  """``min(rate, (1 + n) / (10 + n))`` at n = 0, 1, 2 and far on, as the
  JAX state computes it."""
  for n in (0, 1, 2, 10 ** 6):
    want = float(jax_state.ema_decay(jnp.asarray(n, jnp.int32), 0.9999))
    assert state_lib.ema_decay(n, 0.9999) == want
  assert state_lib.ema_decay(0, 0.9999) == np.float32(0.1)


def test_ema_helper_matches_jax():
  """``models/ema.py``: the reference-style helper counts the update
  first, as the JAX one does (decay 2/11 at the first update)."""
  from b_pinn_kalman_filter_tpu.models.ema import (
      ExponentialMovingAverage as JaxEMA)
  from b_pinn_kalman_filter_tpu_torch.models.ema import (
      ExponentialMovingAverage)
  rng = np.random.default_rng(6)
  start = {'a': rng.standard_normal((3, 4)).astype(np.float32)}
  port = ExponentialMovingAverage({'a': torch.from_numpy(start['a'])}, 0.999)
  ref = JaxEMA({'a': jnp.asarray(start['a'])}, 0.999)
  for _ in range(3):
    new = {'a': rng.standard_normal((3, 4)).astype(np.float32)}
    port.update({'a': torch.from_numpy(new['a'])})
    ref.update({'a': jnp.asarray(new['a'])})
  assert port.num_updates == ref.num_updates == 3
  compare_trees({'a': port.shadow_params['a'].numpy()}, ref.shadow_params,
                MOMENT_TOL, 'ema helper')
