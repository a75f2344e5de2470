"""sub-VP DDPM, continuous (copy of the JAX package's
``configs/subvp/cifar10_ddpm_continuous.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs.vp.ddpm import cifar10


def get_config():
  config = cifar10.get_config()
  config.training.sde = 'subvpsde'
  config.training.continuous = True
  config.sampling.predictor = 'euler_maruyama'
  return config
