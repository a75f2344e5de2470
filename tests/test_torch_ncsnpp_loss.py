"""The continuous VE DSM loss through the port's NCSN++ against the JAX
package's, in f32 on the CPU at ``TINY_NCSNPP`` (the VE axis set): one
jitted JAX ``value_and_grad``, the port's loss and autograd gradients
under the t and z that JAX draws from the same key, dropout 0 (masks are
not shared across frameworks).  The Fourier projection ``W`` is a leaf on
both sides with a zero gradient; a JAX train state crosses by
``convert.train_state_from_jax`` with its Adam moments and EMA on the
same leaves, and one port step leaves ``W`` and its moments as they were.
One test (one JAX program; see ``test_torch_ncsnpp.py``).  Limits:
``tests/port_parity.py``'s, 1e-4 of max |JAX| for the loss and over the
gradient tree."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from b_pinn_kalman_filter_tpu import models as jax_models
from b_pinn_kalman_filter_tpu.core import losses as jax_losses
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.models import convert, ncsnpp
from tests import port_parity
from tests.port_parity import LEAF_TOL, LOSS_TOL, compare_trees
from tests.port_parity import one_torch_thread  # noqa: F401

W = 'GaussianFourierProjection_0.W'


def test_ve_dsm_loss_and_gradients_match_jax():
  jax_config, torch_config = port_parity.tiny_ncsnpp_configs('ve')
  for config in (jax_config, torch_config):
    config.model.dropout = 0.0
  _, params = port_parity.jax_tiny_model(jax_config, seed=5)
  j_sde, _ = jax_sde.get_sde(jax_config)
  loss_fn = jax_losses.get_sde_loss_fn(
      j_sde, jax_models.create_model(jax_config), train=True,
      reduce_mean=False, continuous=True, likelihood_weighting=False)
  batch = np.random.default_rng(3).uniform(
      -1, 1, (4, 16, 16, 1)).astype(np.float32)
  rng = jax.random.PRNGKey(13)
  j_loss, j_grads = jax.jit(
      jax.value_and_grad(lambda p, b: loss_fn(rng, p, b)),
      compiler_options=port_parity.FAST_COMPILE)(params, jnp.asarray(batch))
  t_rng, z_rng, _ = jax.random.split(rng, 3)
  t = jax.random.uniform(t_rng, (batch.shape[0],), minval=1e-5,
                         maxval=j_sde.T)
  z = jax.random.normal(z_rng, batch.shape)

  model = ncsnpp.NCSNpp(torch_config).eval()
  convert.params_from_jax(params, model)
  sde, _ = sde_lib.get_sde(torch_config)
  named = dict(model.named_parameters())
  loss = losses.get_sde_loss_fn(sde, model, True, reduce_mean=False,
                                likelihood_weighting=False)(
      named, torch.from_numpy(batch),
      noise=(torch.from_numpy(np.array(t)), torch.from_numpy(np.array(z))))
  grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                              materialize_grads=True)
  assert abs(float(loss.detach()) - float(j_loss)) <= LOSS_TOL * abs(float(j_loss))
  got = {}
  for name, g in zip(named, grads):
    node = got
    *parents, leaf = name.split('.')
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = g.numpy()
  compare_trees(got, j_grads, LEAF_TOL, 'VE DSM gradients')
  assert not np.asarray(j_grads['GaussianFourierProjection_0']['W']).any()
  assert not got['GaussianFourierProjection_0']['W'].any()

  # The train state: the same leaves in the parameters, Adam's moments and
  # the EMA; one port step keeps W and zero moments for it.
  tx = jax_losses.get_optimizer(jax_config)
  j_state = port_parity.jax_state_init(tx, jax_config.model.ema_rate)(params)
  state = convert.train_state_from_jax(j_state, model)
  assert set(state.params) == set(state.opt_state.mu) == set(
      state.ema_params) == set(named)
  w0 = state.params[W].detach().clone()
  step_fn = losses.get_step_fn(sde, model, losses.get_optimizer(
      torch_config), train=True, reduce_mean=False, continuous=True)
  state, loss = step_fn(state, torch.from_numpy(batch),
                        generator=torch.Generator().manual_seed(0))
  assert torch.isfinite(loss) and state.step == 1
  assert torch.equal(state.params[W], w0)
  assert not state.opt_state.mu[W].any() and not state.opt_state.nu[W].any()
