"""Default NC (ocean netCDF) config (copy of the JAX package's
``configs/default_nc_configs.py``; same keys and values).  The execution
block comes in as the CIFAR-10 config's does."""

from b_pinn_kalman_filter_tpu_torch.configs.config_dict import ConfigDict
from b_pinn_kalman_filter_tpu_torch.configs.default_cifar10_configs import (
    add_execution_defaults)


def get_default_configs():
  config = ConfigDict()
  # training
  config.training = training = ConfigDict()
  config.training.batch_size = 64
  training.n_iters = 50000
  training.snapshot_freq = 10000
  training.log_freq = 500
  training.eval_freq = 100
  training.snapshot_freq_for_preemption = 25000
  training.snapshot_sampling = True
  training.likelihood_weighting = False
  training.continuous = True
  training.reduce_mean = False

  # sampling
  config.sampling = sampling = ConfigDict()
  sampling.n_steps_each = 1
  sampling.noise_removal = True
  sampling.probability_flow = False
  sampling.snr = 0.075

  # evaluation
  config.eval = evaluate = ConfigDict()
  evaluate.begin_ckpt = 50
  evaluate.end_ckpt = 96
  evaluate.batch_size = 512
  evaluate.enable_sampling = True
  evaluate.num_samples = 50000
  evaluate.enable_loss = True
  evaluate.enable_bpd = False
  evaluate.bpd_dataset = 'test'
  evaluate.wait_for_ckpt = False

  # data
  config.data = data = ConfigDict()
  data.dataset = 'NC'
  data.image_size = 64
  data.random_flip = False
  data.uniform_dequantization = False
  data.centered = False
  data.num_channels = 1
  data.category = 'Theta'
  data.key = 'THETA'
  data.date_range = '2013to2017_1day'
  data.depth = 0
  data.land_cut = 200

  # model
  config.model = model = ConfigDict()
  model.sigma_max = 378
  model.sigma_min = 0.01
  model.num_scales = 2000
  model.beta_min = 0.1
  model.beta_max = 20.
  model.dropout = 0.
  model.embedding_type = 'fourier'

  # optimization
  config.optim = optim = ConfigDict()
  optim.weight_decay = 0
  optim.optimizer = 'Adam'
  optim.lr = 2e-4
  optim.beta1 = 0.9
  optim.eps = 1e-8
  optim.warmup = 5000
  optim.grad_clip = 1.

  config.seed = 42
  config = add_execution_defaults(config)
  # The JAX package chunks the NC family's PC scan into 40 dispatches; the
  # port's PC loop dispatches step by step whatever this says.
  config.sampling.pc_chunks = 40
  return config
