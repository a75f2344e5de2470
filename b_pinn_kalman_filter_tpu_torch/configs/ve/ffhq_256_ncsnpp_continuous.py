"""NCSN++ on FFHQ 256x256, continuous VE (copy of the JAX package's
``configs/ve/ffhq_256_ncsnpp_continuous.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import (
    ncsnpp_highres_model)
from b_pinn_kalman_filter_tpu_torch.configs.default_lsun_configs import (
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

  data = config.data
  data.dataset = 'FFHQ'
  data.image_size = 256

  ncsnpp_highres_model(config.model)
  config.model.sigma_max = 348
  # A JAX chunking knob, kept for the same keys: the port's PC loop
  # dispatches step by step.
  config.sampling.pc_chunks = 40
  return config
