"""PINN on Navier–Stokes PDE data (copy of the JAX package's
``configs/pinn/pinn_pde.py``)."""

from b_pinn_kalman_filter_tpu_torch.configs.config_dict import ConfigDict
from b_pinn_kalman_filter_tpu_torch.configs.pinn.pinn_default_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()

  data = config.data
  data.dataset = 'PDE'
  data.dt = 1.7
  data.time_trim = 300

  # inpaint
  inverse = config.inverse = ConfigDict()
  inverse.operator = 'inpaint_rnd'
  inverse.invert = False
  inverse.ratio = 0.9
  inverse.variance = 0.01

  # ukf
  kf = config.kf = ConfigDict()
  kf.patch_size = 8

  return config
