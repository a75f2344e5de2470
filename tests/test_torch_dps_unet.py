"""DPS through a tiny DDPM U-Net, the port against the JAX package: the
guidance's gradient runs through the conv (K1) and GroupNorm (K2) sites'
plain versions and their backward on the CPU.  Limit: 1e-4 relative to
max |JAX| (f32)."""

import jax
import jax.numpy as jnp
import torch

from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu.inverse import conditional_sampling as jax_cs
from b_pinn_kalman_filter_tpu.inverse import obsv_sde as jax_obsv
from b_pinn_kalman_filter_tpu.inverse import operators as jax_ops
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.inverse import conditional_sampling as cs
from b_pinn_kalman_filter_tpu_torch.inverse import obsv_sde, operators
from tests import inverse_parity as ip
from tests.port_parity import FAST_COMPILE, _rel
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4


def _unet_configs():
  j_config, p_config = ip.mlp_configs(size=8)
  for config in (j_config, p_config):
    config.model.name = 'ddpm'
    config.model.nf, config.model.ch_mult = 32, (1, 2)
    config.model.num_res_blocks, config.model.attn_resolutions = 1, (4,)
    config.inverse.solver, config.inverse.dpm_steps = 'dpm', 2
  return j_config, p_config


def test_dps_through_a_tiny_unet_matches_jax():
  """DPS (``dpm``, 2 steps) through the DDPM U-Net at nf 32, ch_mult
  (1, 2), one res block, 8x8x1, batch 2, every parameter randomised: the
  guidance is the gradient through the conv and GroupNorm sites' plain
  versions and their backward.  (nf 16 is no DDPM width: GroupNorm(32)
  cannot split the up path's 48-channel concatenation.)"""
  j_config, p_config = _unet_configs()
  j_model, params = ip.jax_model(j_config, seed=3)
  p_model = ip.torch_model(p_config, params)
  shape = (2, 8, 8, 1)
  mask = ip.checkerboard(8, 8)
  x0 = ip.origin(shape)
  j_op = jax_ops.InpaintOperator(mask=mask)
  p_op = operators.InpaintOperator(mask=mask)
  j_obsv = jax_obsv.LOBSVSDE(jax_sde.get_sde(j_config)[0],
                             j_op(jnp.asarray(x0), keep_shape=False), j_op)
  p_obsv = obsv_sde.LOBSVSDE(sde_lib.get_sde(p_config)[0],
                             p_op(torch.tensor(x0), keep_shape=False), p_op)
  rng = jax.random.PRNGKey(12)
  j_fn = jax_cs.get_dps_sampler(j_config, j_obsv, shape)
  want = jax.jit(lambda r, p: j_fn(r, j_model, p),
                 compiler_options=FAST_COMPILE)(rng, params)
  z, obs_noise, _ = ip.jax_draws(rng, shape, p_obsv.y0.shape)
  got = cs.get_dps_sampler(p_config, p_obsv, shape, device='cpu')(
      p_model, None, z=z, obs_noise=obs_noise)
  assert torch.isfinite(got).all()
  assert _rel(got.numpy(), want) <= TOL
