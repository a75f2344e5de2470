"""Controlled-projection inpainting on NC (copy of the JAX package's
``configs/inverse/nc_ddpmpp_inpaint.py``)."""

from b_pinn_kalman_filter_tpu_torch.configs.config_dict import ConfigDict
from b_pinn_kalman_filter_tpu_torch.configs.default_cifar10_configs import (
    add_inverse_extensions)
from b_pinn_kalman_filter_tpu_torch.configs.vp import nc_ddpmpp


def get_config():
  config = nc_ddpmpp.get_config()
  config.training.batch_size = 16

  inverse = config.inverse = ConfigDict()
  inverse.operator = 'inpaint'
  inverse.invert = False
  inverse.ratio = 0.5
  inverse.sampler = 'controlled'
  inverse.variance = 0.1
  inverse.solver = 'fixed'  # 'RK45', 'RK23', 'fixed', 'dpm'
  add_inverse_extensions(inverse)
  return config
