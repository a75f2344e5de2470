"""VP DDPM++ on NC chlorophyll data (copy of the JAX package's
``configs/vp/nc_chl_ddpmpp.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs.vp import nc_ddpmpp


def get_config():
  config = nc_ddpmpp.get_config()
  data = config.data
  data.category = 'Chl'
  data.key = 'BLGCHL'
  data.date_range = '2013to2017_5day'
  return config
