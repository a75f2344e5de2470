"""Shared set-up for the parity tests of the PyTorch port against the JAX
package: one tiny DDPM config applied to both packages' config trees, and
flax params with every leaf randomised from a numpy seed."""

import numpy as np
import pytest
import torch

@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """Compare on one torch thread (xdist runs several workers per host);
  the worker's previous setting is restored after the module."""
  previous = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(previous)


# nf 32 keeps GroupNorm(min(32, C)) well defined; two levels at 8x8 and
# 4x4 with attention at 8x8 exercise the down, middle and up attention.
TINY_DDPM = {
    ('data', 'image_size'): 8,
    ('data', 'num_channels'): 3,
    ('model', 'nf'): 32,
    ('model', 'ch_mult'): (1, 2),
    ('model', 'num_res_blocks'): 1,
    ('model', 'attn_resolutions'): (8,),
    ('model', 'num_scales'): 4,
    ('tpu', 'compute_dtype'): 'float32',
}


def tiny_configs():
  """The flagship config of each package, cut to ``TINY_DDPM``."""
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  out = []
  for mod in (jax_configs, torch_configs):
    config = mod.get_config('vp/cifar10_ddpmpp_continuous')
    for (block, key), value in TINY_DDPM.items():
      setattr(getattr(config, block), key, value)
    out.append(config)
  return tuple(out)


def randomized_params(params, seed=0):
  """Every leaf of a flax params tree redrawn as numpy float32: kernels
  ~ N(0, 1/fan_in), biases ~ N(0, 0.1), GroupNorm scales ~ 1 + N(0, 0.1)."""
  rng = np.random.default_rng(seed)

  def redraw(tree):
    out = {}
    for key, value in tree.items():
      if hasattr(value, 'items'):
        out[key] = redraw(value)
        continue
      shape = tuple(value.shape)
      if len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1]))
        leaf = rng.standard_normal(shape) / np.sqrt(fan_in)
      elif key == 'scale':
        leaf = 1.0 + 0.1 * rng.standard_normal(shape)
      else:
        leaf = 0.1 * rng.standard_normal(shape)
      out[key] = leaf.astype(np.float32)
    return out

  return redraw(params)


def jax_tiny_model(config, seed=0):
  """(jitted flax DDPM ``apply(params, x, labels)``, randomised params as
  nested numpy dicts).  The init is only shape-traced: every leaf is
  redrawn anyway, and tracing is seconds faster than running it."""
  import jax
  import jax.numpy as jnp
  from b_pinn_kalman_filter_tpu import models as mutils
  model = mutils.create_model(config)
  size, ch = config.data.image_size, config.data.num_channels
  shapes = jax.eval_shape(lambda: model.init(
      {'params': jax.random.PRNGKey(seed), 'dropout': jax.random.PRNGKey(0)},
      jnp.zeros((1, size, size, ch)), jnp.zeros((1,)), train=False))
  apply = jax.jit(lambda p, x, labels: model.apply(
      {'params': p}, x, labels, train=False))
  return apply, randomized_params(shapes['params'], seed)
