"""PINN on NC ocean data (copy of the JAX package's
``configs/pinn/pinn_nc.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs.pinn.pinn_default_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()

  data = config.data
  data.dataset = 'NC_P'
  data.category = 'Theta'
  data.key = 'THETA'
  data.date_range = '2013to2017_1day'
  data.depth = 0
  data.land_cut = 200

  return config
