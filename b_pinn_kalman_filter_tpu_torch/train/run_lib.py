"""Entry points.  So far: ``sample``, the serving path.

Counterpart of the JAX package's ``train/run_lib.py`` ``sample``, without
checkpoints: the weights are a flax ``params`` tree handed in (the JAX
package's own, through ``models.convert.params_from_jax``) or the model's
seeded init.  Checkpoints come with a later slice.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from b_pinn_kalman_filter_tpu_torch.core import sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data.scalers import get_data_inverse_scaler
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import registry as mutils
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax


def sample(config, params: Optional[Mapping[str, Any]] = None, *,
           batch_size: Optional[int] = None, seed: Optional[int] = None,
           device=None, model: Optional[torch.nn.Module] = None
           ) -> Tuple[torch.Tensor, int]:
  """Draw ``batch_size`` samples (NHWC, inverse-scaled) on ``device``.

  ``batch_size`` defaults to ``config.training.batch_size`` and ``seed`` to
  ``config.seed``; the seed drives both the model's init (when neither
  ``params`` nor ``model`` is given) and the sampler's noise.  ``model``
  lets a server build the network once and reuse it across requests.
  Returns ``(samples, nfe)``.
  """
  device = get_device(device)
  seed = config.seed if seed is None else seed
  batch_size = config.training.batch_size if batch_size is None else batch_size
  if model is None:
    model = mutils.create_model(config, device=device, seed=seed)
    if params is not None:
      params_from_jax(params, model)
  elif params is not None:
    raise ValueError('pass params or model, not both')

  sde, sampling_eps = sde_lib.get_sde(config)
  shape = (batch_size, config.data.image_size, config.data.image_size,
           config.data.num_channels)
  sampling_fn = sampling.get_sampling_fn(
      config, sde, model, shape, get_data_inverse_scaler(config),
      sampling_eps, device=device)
  generator = torch.Generator(device=device).manual_seed(seed)
  return sampling_fn(generator=generator)
