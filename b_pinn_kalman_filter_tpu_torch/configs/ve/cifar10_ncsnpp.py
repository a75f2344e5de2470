"""VE NCSN++ on CIFAR-10, discrete (copy of the JAX package's
``configs/ve/cifar10_ncsnpp.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import ncsnpp_model
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

  ncsnpp_model(config.model)
  config.model.embedding_type = 'positional'
  return config
