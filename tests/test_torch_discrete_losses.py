"""The discrete score-matching losses: the port's SMLD (VE SDE) and DDPM
(VP SDE) losses and gradients against the JAX package's under replayed
draws (f32, CPU, ``TINY_DDPM``), one jitted JAX ``value_and_grad`` per
loss.  The file holds these two tests, so that xdist's ``loadfile`` hands
it out among the last files; the port-only checks of the discrete step
and ``--mode train`` on ``vp/nc_ddpmpp`` are
tests/test_torch_discrete_steps.py.  Limits: ``tests/port_parity.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu import models as jax_models
from b_pinn_kalman_filter_tpu.core import losses as jax_losses
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.models import convert, ddpm
from tests import port_parity
from tests.port_parity import LEAF_TOL, LOSS_TOL, compare_trees
from tests.port_parity import one_torch_thread  # noqa: F401

# (SDE, the JAX loss, reduce_mean): the DDPM loss as vp/nc_ddpmpp takes
# it (mean over each image), the SMLD loss with the half sum.
CASES = {'ddpm': ('vpsde', jax_losses.get_ddpm_loss_fn, True),
         'smld': ('vesde', jax_losses.get_smld_loss_fn, False)}


def _configs(sde_name):
  jax_config, torch_config = port_parity.tiny_configs()
  for config in (jax_config, torch_config):
    config.training.sde = sde_name
    config.model.dropout = 0.0
  return jax_config, torch_config


@pytest.fixture(scope='module')
def tiny_params():
  """The tiny DDPM's randomised flax params (one tree for both SDEs)."""
  jax_config, _ = _configs('vpsde')
  return port_parity.jax_tiny_model(jax_config, seed=4)[1]


@pytest.mark.parametrize('case', list(CASES))
def test_discrete_loss_and_gradients_match_jax(case, tiny_params):
  """One jitted JAX ``value_and_grad`` of the loss; the port's loss and
  autograd gradients under the labels and noise JAX draws from the same
  key (``l_rng, z_rng, drop_rng = split(rng, 3)``)."""
  sde_name, jax_loss_fn, reduce_mean = CASES[case]
  jax_config, torch_config = _configs(sde_name)
  params = tiny_params
  j_sde, _ = jax_sde.get_sde(jax_config)
  loss_fn = jax_loss_fn(j_sde, jax_models.create_model(jax_config),
                        train=True, reduce_mean=reduce_mean)
  batch = port_parity.train_batch(1)
  rng = jax.random.PRNGKey(11)
  j_loss, j_grads = jax.jit(
      jax.value_and_grad(lambda p, b: loss_fn(rng, p, b)),
      compiler_options=port_parity.FAST_COMPILE)(params, jnp.asarray(batch))
  l_rng, z_rng, _ = jax.random.split(rng, 3)
  labels = jax.random.randint(l_rng, (batch.shape[0],), 0, j_sde.N)
  z = jax.random.normal(z_rng, batch.shape)

  model = ddpm.DDPM(torch_config).eval()
  convert.params_from_jax(params, model)
  sde, _ = sde_lib.get_sde(torch_config)
  port_fn = {'ddpm': losses.get_ddpm_loss_fn,
             'smld': losses.get_smld_loss_fn}[case](
                 sde, model, True, reduce_mean=reduce_mean)
  named = dict(model.named_parameters())
  loss = port_fn(named, torch.from_numpy(batch), noise=(
      torch.from_numpy(np.array(labels)).long(),
      torch.from_numpy(np.array(z))))
  grads = torch.autograd.grad(loss, list(named.values()))
  loss = float(loss.detach())
  assert abs(loss - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
  got = {}
  for name, g in zip(named, grads):
    node = got
    *parents, leaf = name.split('.')
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = g.numpy()
  compare_trees(got, j_grads, LEAF_TOL, f'{case} gradients')
