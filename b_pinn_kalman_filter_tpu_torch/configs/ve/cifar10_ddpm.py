"""Original DDPM model trained with SMLD/VE (copy of the JAX package's
``configs/ve/cifar10_ddpm.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import ddpm_cifar_model
from b_pinn_kalman_filter_tpu_torch.configs.default_cifar10_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()
  training = config.training
  training.sde = 'vesde'
  training.continuous = False

  sampling = config.sampling
  sampling.method = 'pc'
  sampling.predictor = 'reverse_diffusion'
  sampling.corrector = 'langevin'

  model = ddpm_cifar_model(config.model)
  model.scale_by_sigma = True
  model.ema_rate = 0.999
  model.conv_size = 3
  return config
