"""The port's PC sampler (euler_maruyama + none) against the JAX sampler on
the tiny DDPM, with the JAX key schedule replayed and its normals fed to the
port (f32, CPU)."""

import jax
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.core import sampling as jax_sampling
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu.data.datasets import get_data_inverse_scaler
from b_pinn_kalman_filter_tpu import models as jax_models
from b_pinn_kalman_filter_tpu_torch.core import sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data import scalers
from b_pinn_kalman_filter_tpu_torch.models import ddpm as torch_ddpm
from b_pinn_kalman_filter_tpu_torch.models import registry
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

SHAPE = (2, 8, 8, 3)


def _replayed_normals(rng, N):
  """The normals the JAX PC sampler draws (core/sampling.py:259-274): the
  prior from a split-off key, then per step split(rng, N)[i] -> (c, p) and
  z from p (corrector 'none' draws nothing)."""
  rng, prior_rng = jax.random.split(rng)
  out = [np.array(jax.random.normal(prior_rng, SHAPE))]
  for step_rng in jax.random.split(rng, N):
    _, p_rng = jax.random.split(step_rng)
    out.append(np.array(jax.random.normal(p_rng, SHAPE)))
  return out


def test_pc_sampler_matches_jax_under_replayed_noise():
  jax_config, torch_config = port_parity.tiny_configs()
  _, params = port_parity.jax_tiny_model(jax_config)
  rng = jax.random.PRNGKey(7)

  sde, eps = jax_sde.get_sde(jax_config)
  jax_fn = jax_sampling.get_sampling_fn(
      jax_config, sde, jax_models.create_model(jax_config), SHAPE,
      get_data_inverse_scaler(jax_config), eps)
  want, want_nfe = jax_fn(rng, params)
  want = np.asarray(want)

  port = torch_ddpm.DDPM(torch_config)
  params_from_jax(params, port.eval())
  tsde, teps = sde_lib.get_sde(torch_config)
  fn = sampling.get_sampling_fn(
      torch_config, tsde, port, SHAPE,
      scalers.get_data_inverse_scaler(torch_config), teps, device='cpu')
  noise = [torch.from_numpy(z) for z in _replayed_normals(rng, tsde.N)]
  got, nfe = fn(noise=noise)

  assert nfe == want_nfe == 8          # N * (n_steps + 1)
  assert got.shape == SHAPE and np.isfinite(got.numpy()).all()
  scale = np.abs(want).max()
  assert np.abs(got.numpy() - want).max() / scale <= 1e-4


def test_generator_draws_are_reproducible():
  _, torch_config = port_parity.tiny_configs()
  torch_config.model.num_scales = 2
  sde, eps = sde_lib.get_sde(torch_config)
  fn = sampling.get_pc_sampler_from_score(
      sde, SHAPE, sampling.get_predictor('euler_maruyama'),
      sampling.get_corrector('none'), lambda x: x, snr=0.16, eps=eps,
      device='cpu')
  score = lambda x, t: -x           # the score of N(0, I)
  a, _ = fn(score, generator=torch.Generator().manual_seed(3))
  b, _ = fn(score, generator=torch.Generator().manual_seed(3))
  assert torch.equal(a, b)


@pytest.mark.parametrize('kind,name', [('predictor', 'reverse_diffusion'),
                                       ('predictor', 'ancestral_sampling'),
                                       ('corrector', 'langevin'),
                                       ('corrector', 'ald')])
def test_unported_samplers_name_the_roadmap(kind, name):
  """The four updates that once raised naming their ROADMAP.md item (the
  name is kept from then) are ported and held against JAX in
  tests/test_torch_ode.py: each name gives its update, and an unknown name
  raises ``KeyError``."""
  getter = getattr(sampling, f'get_{kind}')
  assert getter(name) is getattr(sampling, f'{name}_{kind}')
  with pytest.raises(KeyError):
    getter(f'{name}_unknown')


@pytest.mark.parametrize('method,item', [('ode', 'A.6'),
                                         ('dpm_solver', 'A.4')])
def test_unported_methods_name_the_roadmap(method, item):
  """The ODE sampler (ROADMAP.md A.6) and DPM-Solver++ (A.4) once raised
  naming their items (the name is kept from then); ``get_sampling_fn``
  now builds them, and each samples the tiny DDPM (held against JAX on
  the MLP in tests/test_torch_samplers.py)."""
  _, config = port_parity.tiny_configs()
  config.sampling.method = method
  config.sampling.dpm_steps = 2
  sde, eps = sde_lib.get_sde(config)
  model = registry.create_model(config, device='cpu')
  fn = sampling.get_sampling_fn(config, sde, model, SHAPE, lambda x: x, eps,
                                device='cpu')
  samples, nfe = fn(generator=torch.Generator().manual_seed(0))
  assert samples.shape == SHAPE and torch.isfinite(samples).all(), item
  # DPM-Solver: 2 steps and the denoising prediction; ODE: 1 + 6 a step.
  assert nfe == 3 if method == 'dpm_solver' else (nfe - 1) % 6 == 0, item
