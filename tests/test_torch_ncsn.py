"""The class-conditional NCSN (``ncsn``) and the SMLD loss through NCSNv2,
the port against the JAX package in f32 on the CPU at nf 8
(``tests/port_parity.py`` ``tiny_ncsn_configs``): ``ncsn``'s forward at
16x16 (its conditional norms indexed by the noise level), and the SMLD
loss of ``ve/ncsnv2/cifar10`` (the half sum over each image, as the config
trains) with its gradients at ``ncsnv2_64``, by one jitted JAX
``value_and_grad`` (at XLA's default optimisation level) under the labels
and noise JAX draws from its key.  The
file holds these two tests, one JAX program each, so that xdist's
``loadfile`` hands it out among the last files.  Limits: 1e-4 of max
|JAX| (the gradients over the whole tree, ``port_parity.compare_trees``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from b_pinn_kalman_filter_tpu import models as jax_models
from b_pinn_kalman_filter_tpu.core import losses as jax_losses
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.models import convert, ncsnv2
from tests import port_parity
from tests.port_parity import LEAF_TOL, LOSS_TOL, compare_trees
from tests.port_parity import one_torch_thread  # noqa: F401
from tests.test_torch_ncsnv2 import check_forward


def test_ncsn_matches_jax():
  model = check_forward('ncsn', 16, seed=3)
  assert isinstance(model, ncsnv2.NCSN)
  names = dict(model.named_parameters())
  assert ('ConditionalResidualBlock_0.ConditionalInstanceNorm2dPlus_0'
          '.Embed_0.embedding') in names
  assert names['ConditionalInstanceNorm2dPlus_0.Embed_0.embedding'].shape \
      == (8, 3 * 8)


def test_smld_loss_and_gradients_match_jax():
  jax_config, torch_config = port_parity.tiny_ncsn_configs('ncsnv2_64', 16)
  assert not jax_config.training.continuous
  assert not jax_config.training.reduce_mean
  _, params = port_parity.jax_tiny_model(
      jax_config, seed=5, compiler_options=port_parity.FAST_COMPILE,
      scales=port_parity.NCSN_SCALES)
  j_sde, _ = jax_sde.get_sde(jax_config)
  loss_fn = jax_losses.get_smld_loss_fn(
      j_sde, jax_models.create_model(jax_config), train=True,
      reduce_mean=False)
  rng_np = np.random.default_rng(7)
  batch = rng_np.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
  rng = jax.random.PRNGKey(13)
  # At the default optimisation level: at XLA's lowest
  # (``port_parity.FAST_COMPILE``) JAX's own gradients are up to 3.9e-4
  # of the largest leaf off the float64 ones (the port's 4e-7).
  j_loss, j_grads = jax.jit(
      jax.value_and_grad(lambda p, b: loss_fn(rng, p, b)))(
          params, jnp.asarray(batch))
  l_rng, z_rng, _ = jax.random.split(rng, 3)
  labels = jax.random.randint(l_rng, (batch.shape[0],), 0, j_sde.N)
  z = jax.random.normal(z_rng, batch.shape)

  model = ncsnv2.NCSNv2(torch_config).eval()
  convert.params_from_jax(params, model)
  sde, _ = sde_lib.get_sde(torch_config)
  port_fn = losses.get_smld_loss_fn(sde, model, True, reduce_mean=False)
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
  compare_trees(got, j_grads, LEAF_TOL, 'smld gradients')
