"""VP DDPM++ on NC ocean data (copy of the JAX package's
``configs/vp/nc_ddpmpp.py``)."""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import ddpmpp_model
from b_pinn_kalman_filter_tpu_torch.configs.default_nc_configs import (
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
  data.category = 'Theta'
  data.key = 'THETA'
  data.date_range = '2013to2017_1day'

  ddpmpp_model(config.model)
  return config
