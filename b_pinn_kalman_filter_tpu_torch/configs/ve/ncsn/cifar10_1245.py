"""NCSN with techniques 1,2,4,5 on CIFAR-10 (copy of the JAX package's
``configs/ve/ncsn/cifar10_1245.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import (
    ncsn_model, ncsn_optim)
from b_pinn_kalman_filter_tpu_torch.configs.default_cifar10_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()
  training = config.training
  training.sde = 'vesde'
  training.continuous = False

  sampling = config.sampling
  sampling.method = 'pc'
  sampling.predictor = 'none'
  sampling.corrector = 'ald'
  sampling.n_steps_each = 5
  sampling.snr = 0.176

  ncsn_model(config.model)
  config.model.num_scales = 232
  config.model.ema_rate = 0.999

  ncsn_optim(config.optim)
  return config
