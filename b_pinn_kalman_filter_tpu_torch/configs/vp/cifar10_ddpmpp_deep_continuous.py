"""VP DDPM++ deep on CIFAR-10, continuous (copy of the JAX package's
``configs/vp/cifar10_ddpmpp_deep_continuous.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs.vp import cifar10_ddpmpp_continuous


def get_config():
  config = cifar10_ddpmpp_continuous.get_config()
  config.training.n_iters = 950001
  config.model.num_res_blocks = 8
  return config
