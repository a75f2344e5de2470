"""VE NCSN++ on CelebA (copy of the JAX package's
``configs/ve/celeba_ncsnpp.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import ncsnpp_model
from b_pinn_kalman_filter_tpu_torch.configs.default_celeba_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()
  training = config.training
  training.sde = 'vesde'
  training.continuous = True

  sampling = config.sampling
  sampling.method = 'pc'
  sampling.predictor = 'reverse_diffusion'
  sampling.corrector = 'langevin'

  ncsnpp_model(config.model)
  return config
