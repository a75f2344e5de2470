"""NCSNv2 on LSUN bedroom 128x128 (copy of the JAX package's
``configs/ve/ncsnv2/bedroom.py``; same keys and values).

Reference quirk, preserved in spirit: the reference sets
``training.continuouse = False`` (typo, ve/ncsnv2/bedroom.py:29), so
``training.continuous`` actually stays True from the LSUN defaults and the
model trains with the continuous VE loss.  The JAX package reproduces the
effective behavior (continuous stays True) rather than the typo.
"""

from b_pinn_kalman_filter_tpu_torch.configs.default_lsun_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()
  training = config.training
  training.batch_size = 128
  training.sde = 'vesde'

  sampling = config.sampling
  sampling.method = 'pc'
  sampling.predictor = 'none'
  sampling.corrector = 'ald'
  sampling.n_steps_each = 3
  sampling.snr = 0.095

  data = config.data
  data.category = 'bedroom'
  data.image_size = 128

  model = config.model
  model.name = 'ncsnv2_128'
  model.scale_by_sigma = True
  model.sigma_max = 190
  model.num_scales = 1086
  model.ema_rate = 0.9999
  model.sigma_min = 0.01
  model.normalization = 'InstanceNorm++'
  model.nonlinearity = 'elu'
  model.nf = 128
  model.interpolation = 'bilinear'

  optim = config.optim
  optim.weight_decay = 0
  optim.optimizer = 'Adam'
  optim.lr = 1e-4
  optim.beta1 = 0.9
  optim.amsgrad = False
  optim.eps = 1e-8
  optim.warmup = 0
  optim.grad_clip = -1.
  return config
