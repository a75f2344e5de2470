"""Discrete DDPM on LSUN bedroom (copy of the JAX package's
``configs/vp/ddpm/bedroom.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import ddpm_highres_model
from b_pinn_kalman_filter_tpu_torch.configs.default_lsun_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()
  training = config.training
  training.sde = 'vpsde'
  training.continuous = False
  training.reduce_mean = True

  sampling = config.sampling
  sampling.method = 'pc'
  sampling.predictor = 'ancestral_sampling'
  sampling.corrector = 'none'

  data = config.data
  data.category = 'bedroom'
  data.centered = True

  ddpm_highres_model(config.model)
  config.optim.lr = 2e-5
  return config
