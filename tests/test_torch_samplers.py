"""The port's unconditional DPM-Solver++ and probability-flow ODE samplers
(through ``get_sampling_fn``) and its PC inpainter and colorizer against
the JAX package's, on the flat MLP score model with the same randomised
weights and JAX's own draws fed in.

Limits, relative to max |JAX|: 1e-4 in f32 (DPM-Solver, the PC loops);
the ODE sampler's Dormand–Prince in f64 on both sides (its accept/reject
decisions then agree), 1e-10, NFE exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.core import controllable as jax_controllable
from b_pinn_kalman_filter_tpu.core import sampling as jax_sampling
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu_torch.core import controllable, sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data.scalers import (
    get_data_inverse_scaler)
from tests import inverse_parity as ip
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
F64_TOL = 1e-10


def _rel(got, want):
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope='module')
def mlp():
  j_config, p_config = ip.mlp_configs()
  j_model, params = ip.jax_model(j_config)
  return j_config, p_config, j_model, params, ip.torch_model(p_config,
                                                             params)


@pytest.mark.parametrize('order, skip', [(2, 'logsnr'), (1, 'time')])
def test_dpm_solver_sampler(mlp, order, skip):
  j_config, p_config, j_model, params, p_model = mlp
  for config in (j_config, p_config):
    config.sampling.method = 'dpm_solver'
    config.sampling.dpm_steps, config.sampling.dpm_order = 5, order
    config.sampling.dpm_skip = skip
  j_sde, eps = jax_sde.get_sde(j_config)
  rng = jax.random.PRNGKey(4)
  want, want_nfe = jax_sampling.get_sampling_fn(
      j_config, j_sde, j_model, ip.SHAPE, lambda x: x, eps)(rng, params)
  z = ip.tensor(jax.random.normal(jax.random.split(rng, 3)[1], ip.SHAPE))
  p_sde, eps = sde_lib.get_sde(p_config)
  got, nfe = sampling.get_sampling_fn(
      p_config, p_sde, p_model, ip.SHAPE, get_data_inverse_scaler(p_config),
      eps, device='cpu')(z=z)
  assert nfe == int(want_nfe) == 6
  assert _rel(got.numpy(), want) <= TOL


def test_ode_sampler(mlp):
  """``sampling.method='ode'``: Dormand–Prince at rtol = atol = 1e-5, then
  the reverse-diffusion denoising step's mean, in f64 on both sides."""
  j_config, p_config, j_model, params, p_model = mlp
  for config in (j_config, p_config):
    config.sampling.method = 'ode'
  rng = jax.random.PRNGKey(5)
  with jax.enable_x64(True):
    z = jax.random.normal(jax.random.PRNGKey(6), ip.SHAPE)
    j_sde, eps = jax_sde.get_sde(j_config)
    recorded = []
    dopri = jax_sampling.ode_lib.odeint_dopri

    def record(*args, **kwargs):
      recorded.append(dopri(*args, **kwargs))
      return recorded[-1]

    jax_sampling.ode_lib.odeint_dopri = record
    try:
      want, want_nfe = jax_sampling.get_sampling_fn(
          j_config, j_sde, j_model, ip.SHAPE, lambda x: x, eps)(
              rng, params, z=z)
    finally:
      jax_sampling.ode_lib.odeint_dopri = dopri
    want = np.asarray(want)
  p_sde, eps = sde_lib.get_sde(p_config)
  got, nfe = sampling.get_sampling_fn(
      p_config, p_sde, p_model, ip.SHAPE, get_data_inverse_scaler(p_config),
      eps, device='cpu')(z=ip.tensor(z))
  assert want.dtype == np.float64 and got.dtype == torch.float64
  assert nfe == int(want_nfe) == int(recorded[0].nfe) > 20
  assert int(recorded[0].status) == 0
  assert _rel(got.numpy(), want) <= F64_TOL


def _pc_stream(rng, shape, n_scales, n_steps):
  """JAX's draws of a controllable PC loop (corrector ``langevin`` with
  ``n_steps``, predictor ``reverse_diffusion``) in the order the port
  takes them: the prior, then each step's corrector draws and data noise,
  the predictor's draw and data noise."""
  rng, prior_rng = jax.random.split(rng)
  out = [jax.random.normal(prior_rng, shape)]
  for step_rng in jax.random.split(rng, n_scales):
    c_rng, p_rng = jax.random.split(step_rng)
    u_rng, n_rng = jax.random.split(c_rng)
    out += [jax.random.normal(k, shape)
            for k in jax.random.split(u_rng, n_steps)]
    out.append(jax.random.normal(n_rng, shape))
    u_rng, n_rng = jax.random.split(p_rng)
    out += [jax.random.normal(u_rng, shape), jax.random.normal(n_rng, shape)]
  return [ip.tensor(a) for a in out]


PC = dict(snr=0.16, n_steps=2, probability_flow=False, continuous=False,
          denoise=True, eps=1e-3)


def _pc_args(lib):
  return (getattr(lib, 'get_predictor')('reverse_diffusion'),
          getattr(lib, 'get_corrector')('langevin'))


@pytest.mark.parametrize('kind', ['inpainter', 'colorizer'])
def test_controllable(kind):
  """The PC inpainter (1x4x4 masks over 2 images) and the colorizer (a
  three-channel gray batch) at N = 25 steps (fewer make a discrete beta
  exceed 1), discrete score."""
  channels = 1 if kind == 'inpainter' else 3
  j_config, p_config = ip.mlp_configs(channels=channels)
  j_model, params = ip.jax_model(j_config, seed=7)
  p_model = ip.torch_model(p_config, params)
  shape = (2, 4, 4, channels)
  j_sde, p_sde = jax_sde.VPSDE(N=25), sde_lib.VPSDE(N=25)
  rng = jax.random.PRNGKey(8)
  data = ip.origin(shape, seed=10)
  j_fn = getattr(jax_controllable, f'get_pc_{kind}')(
      j_sde, j_model, *_pc_args(jax_sampling), lambda x: x, **PC)
  p_fn = getattr(controllable, f'get_pc_{kind}')(
      p_sde, p_model, *_pc_args(sampling), lambda x: x, device='cpu',
      **PC)
  noise = _pc_stream(rng, shape, 25, PC['n_steps'])
  if kind == 'inpainter':
    mask = np.broadcast_to(ip.checkerboard(4, 4), shape)
    want = j_fn(rng, params, jnp.asarray(data), jnp.asarray(mask))
    got = p_fn(torch.tensor(data), torch.tensor(mask.copy()), noise=noise)
    known = mask > 0
    np.testing.assert_allclose(got.numpy()[known], data[known], rtol=0,
                               atol=0.1)
  else:
    gray = np.repeat(data.mean(-1, keepdims=True), 3, -1)
    want = j_fn(rng, params, jnp.asarray(gray))
    got = p_fn(torch.tensor(gray), noise=noise)
  assert _rel(got.numpy(), want) <= TOL
