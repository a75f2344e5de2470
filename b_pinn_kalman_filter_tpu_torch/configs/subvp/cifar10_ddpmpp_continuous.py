"""sub-VP DDPM++ on CIFAR-10, continuous (copy of the JAX package's
``configs/subvp/cifar10_ddpmpp_continuous.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import ddpmpp_model
from b_pinn_kalman_filter_tpu_torch.configs.default_cifar10_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()
  training = config.training
  training.sde = 'subvpsde'
  training.continuous = True
  training.reduce_mean = True

  sampling = config.sampling
  sampling.method = 'pc'
  sampling.predictor = 'euler_maruyama'
  sampling.corrector = 'none'

  config.data.centered = True

  ddpmpp_model(config.model)
  return config
