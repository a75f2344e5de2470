"""Shared set-up for the inverse suite's parity tests of the PyTorch port
against the JAX package: ``inverse/nc_ddpmpp_inpaint_dps`` cut to a flat
MLP score model at 4x4x1, batch 2, every parameter randomised from a
numpy seed, one observed batch, and JAX's own draws as the port takes
them (``z``, ``obs_noise``, ``noise_at``)."""

import numpy as np
import torch

from tests import port_parity

SHAPE = (2, 4, 4, 1)
EPS = 1e-3


def mlp_configs(size=4, channels=1, batch=2):
  """``inverse/nc_ddpmpp_inpaint_dps`` of each package with the MLP score
  model at ``size`` x ``size`` x ``channels``, batch ``batch``, f32."""
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  out = []
  for mod in (jax_configs, torch_configs):
    config = mod.get_config('inverse/nc_ddpmpp_inpaint_dps')
    config.model.name = 'mlp'
    config.data.image_size = size
    config.data.num_channels = channels
    config.training.batch_size = batch
    config.tpu.compute_dtype = 'float32'
    out.append(config)
  return tuple(out)


def jax_model(config, seed=1):
  """(the flax model of ``config``, its params randomised as numpy)."""
  import jax
  import jax.numpy as jnp
  from b_pinn_kalman_filter_tpu.models import registry
  model = registry.create_model(config)
  size, ch = config.data.image_size, config.data.num_channels
  shapes = jax.eval_shape(lambda: model.init(
      {'params': jax.random.PRNGKey(0), 'dropout': jax.random.PRNGKey(0)},
      jnp.zeros((1, size, size, ch)), jnp.zeros((1,)), train=False))
  return model, port_parity.randomized_params(shapes['params'], seed)


def torch_model(config, params):
  from b_pinn_kalman_filter_tpu_torch.models import convert, registry
  model = registry.create_model(config, device='cpu')
  return convert.params_from_jax(params, model)


def checkerboard(h, w):
  return (np.indices((h, w)).sum(axis=0) % 2).astype(np.float32)[..., None]


def origin(shape=SHAPE, seed=2):
  rng = np.random.default_rng(seed)
  return (0.5 + 0.3 * rng.standard_normal(shape)).astype(np.float32)


def tensor(a):
  return torch.from_numpy(np.array(a))


def jax_draws(rng, shape, y_shape):
  """JAX's (prior, third draw) of ``rng``: ``split(rng, 3)`` gives the
  prior's key and, for DPS, the observation noise's (a normal of
  ``y_shape``), for the controlled sampler the per-t key (returned as
  it is)."""
  import jax
  _, prior_rng, third = jax.random.split(rng, 3)
  z = jax.random.normal(prior_rng, shape)
  obs = jax.random.normal(third, y_shape)
  return tensor(z), tensor(obs), third


def jax_noise_at(key, shape):
  """``noise_at(t)``: JAX's controlled-sampler draw for time t,
  ``normal(fold_in(key, int32(t * 1e6)))``."""
  import jax
  from b_pinn_kalman_filter_tpu_torch.inverse.conditional_sampling import (
      t_key)
  cache = {}

  def noise_at(t):
    k = t_key(t)
    if k not in cache:
      cache[k] = tensor(jax.random.normal(jax.random.fold_in(key, k), shape))
    return cache[k]

  return noise_at
