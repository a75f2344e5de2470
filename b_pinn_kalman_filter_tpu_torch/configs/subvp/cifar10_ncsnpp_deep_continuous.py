"""sub-VP NCSN++ deep, continuous (copy of the JAX package's
``configs/subvp/cifar10_ncsnpp_deep_continuous.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs.subvp import (
    cifar10_ncsnpp_continuous)


def get_config():
  config = cifar10_ncsnpp_continuous.get_config()
  config.training.n_iters = 950001
  config.model.num_res_blocks = 8
  return config
