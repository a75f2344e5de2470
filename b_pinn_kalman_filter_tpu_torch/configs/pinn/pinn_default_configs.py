"""Default PINN config (copy of the JAX package's
``configs/pinn/pinn_default_configs.py``; same keys and values).  The
execution block comes in as the CIFAR-10 config's does."""

from b_pinn_kalman_filter_tpu_torch.configs.config_dict import ConfigDict
from b_pinn_kalman_filter_tpu_torch.configs.default_cifar10_configs import (
    add_execution_defaults)


def get_default_configs():
  config = ConfigDict()
  # training
  config.training = training = ConfigDict()
  config.training.batch_size = 64
  training.n_iters = 35000
  training.n_pinn_iters = 25000
  training.n_bpinn_iters = 40000
  training.snapshot_freq = 5000
  training.snapshot_freq_for_preemption = 250
  training.log_freq = 5
  training.eval_freq = 50
  training.pinn_loss_weight = 1e-5

  # data
  config.data = data = ConfigDict()
  data.num_channels = 1
  data.dataset = '_'
  data.image_size = 64
  data.random_flip = False
  data.uniform_dequantization = False
  data.centered = False

  # model
  config.model = model = ConfigDict()
  model.ema_rate = 0.9
  model.arch = 'flownet'
  model.feature_nums = (16, 32, 64, 96, 128)
  model.spatial_embed_omega = 100
  model.spatial_embed_s_flow = 100
  model.spatial_embed_s_pres = 100
  model.bpinn_moped_delta = 0.01

  # optimization
  config.optim = optim = ConfigDict()
  optim.weight_decay = 0
  optim.bpinn_weight_decay = 0
  optim.optimizer = 'Adam'
  optim.lr = 0.001
  optim.bpinn_lr = 0.0005
  optim.beta1 = 0.9
  optim.eps = 1e-8
  optim.warmup = 100
  optim.grad_clip = 1.

  config.seed = 42
  return add_execution_defaults(config)
