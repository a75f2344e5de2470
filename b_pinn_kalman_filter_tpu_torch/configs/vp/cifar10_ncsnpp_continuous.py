"""VP NCSN++ on CIFAR-10, continuous (copy of the JAX package's
``configs/vp/cifar10_ncsnpp_continuous.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import ncsnpp_model
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
  ncsnpp_model(config.model)
  model = config.model
  model.scale_by_sigma = False
  model.ema_rate = 0.9999
  model.embedding_type = 'positional'
  return config
