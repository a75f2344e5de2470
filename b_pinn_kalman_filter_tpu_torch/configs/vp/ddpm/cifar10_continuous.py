"""Continuous-VP DDPM on CIFAR-10 (copy of the JAX package's
``configs/vp/ddpm/cifar10_continuous.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import ddpm_cifar_model
from b_pinn_kalman_filter_tpu_torch.configs.default_cifar10_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()
  training = config.training
  training.sde = 'vpsde'
  training.continuous = True
  training.reduce_mean = True

  sampling = config.sampling
  sampling.method = 'pc'
  sampling.predictor = 'euler_maruyama'
  sampling.corrector = 'none'

  config.data.centered = True

  ddpm_cifar_model(config.model)
  return config
