"""The ``inverse`` entry point: observe a test batch and sample the
posterior.

Counterpart of the JAX package's ``inverse/inverse_lib.py``, without its
``mesh`` argument (one card; ROADMAP.md A.12).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.core import losses
from b_pinn_kalman_filter_tpu_torch.data.datasets import get_dataset
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.inverse.conditional_sampling import (
    get_sampler)
from b_pinn_kalman_filter_tpu_torch.inverse.obsv_sde import get_obsvsde
from b_pinn_kalman_filter_tpu_torch.inverse.operators import get_operator
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from b_pinn_kalman_filter_tpu_torch.utils.misc import save_image_grid


def _inverse_fn(config, model, params, generator, device, **sampler_kw):
  """(origin, image-shaped observation, posterior sample, operator): the
  first ``training.batch_size`` images of the test split observed through
  the config's operator, then sampled by the config's sampler.
  ``sampler_kw`` go to the sampler (``z``, ``obs_noise``, ``noise_at``,
  ``info``)."""
  size, channels = config.data.image_size, config.data.num_channels
  sampling_shape = (config.training.batch_size, size, size, channels)
  _, test_ds = get_dataset(config)
  item = next(iter(test_ds))
  origin = np.asarray(item[0] if isinstance(item, tuple) else item)
  origin = torch.from_numpy(origin[:config.training.batch_size]).to(device)

  operator = get_operator(config, device=device)
  observation_vis = operator(origin, keep_shape=True)
  observation = operator(origin, keep_shape=False)   # ill-posed (B, C, N)
  obsvsde, sampling_eps = get_obsvsde(config, observation, operator)
  sampling_fn = get_sampler(config, obsvsde, sampling_shape,
                            eps=sampling_eps, device=device)
  sample = sampling_fn(model, params, generator=generator, **sampler_kw)
  return origin, observation_vis, sample, operator


def inverse(config, ckptdir: Optional[str], workdir: str, *, device=None,
            info: Optional[dict] = None):
  """The CLI's ``inverse`` mode on ``device`` (default ``cuda``): the
  model's seeded init, a port checkpoint at ``ckptdir`` restored into its
  train state when given, the posterior sampled under the EMA
  parameters; ``inverse.png``, ``observation.png`` and ``mse.txt`` under
  ``<workdir>/<operator>-<ratio>/``.  Returns (origin, observation,
  sample, mse); ``info`` (a dict) takes the sampler's NFE."""
  device = get_device(device)
  model = mutils.create_model(config, device=device, seed=config.seed)
  state = state_lib.create_train_state(dict(model.named_parameters()),
                                       losses.get_optimizer(config),
                                       config.model.ema_rate)
  if ckptdir:
    state = ckpt_lib.restore_checkpoint(ckptdir, state)
  generator = torch.Generator(device=device).manual_seed(config.seed)
  origin, observation, sample, operator = _inverse_fn(
      config, model, state.ema_params, generator, device, info=info)

  outdir = os.path.join(
      workdir, f'{config.inverse.operator}-{config.inverse.ratio}')
  os.makedirs(outdir, exist_ok=True)
  save_image_grid(sample.float().cpu().numpy(),
                  os.path.join(outdir, 'inverse.png'))
  save_image_grid(observation.float().cpu().numpy(),
                  os.path.join(outdir, 'observation.png'))
  mse = evaluate_inverse(config, origin, sample, operator)
  with open(os.path.join(outdir, 'mse.txt'), 'w') as f:
    f.write(f'{mse}\n')
  return origin, observation, sample, mse


def evaluate_inverse(config, origin, inv, operator) -> float:
  """Reconstruction MSE over the whole image."""
  if config.inverse.operator in ('inpaint', 'inpaint_rnd'):
    return float(torch.mean((origin.float() - inv.float()) ** 2))
  raise NotImplementedError
