"""Default CIFAR-10 config (copy of the JAX package's
``configs/default_cifar10_configs.py`` and ``configs/tpu_defaults.py``).

The keys are the JAX config's.  The execution block keeps its name
``tpu`` so that code reads ``config.tpu.compute_dtype`` in both packages;
on CUDA the hand-written kernels always run, so the JAX switches
``tpu.winograd`` and ``tpu.fused_groupnorm`` are not copied.
"""

from b_pinn_kalman_filter_tpu_torch.configs.config_dict import ConfigDict


def get_default_configs():
  config = ConfigDict()
  # training
  config.training = training = ConfigDict()
  config.training.batch_size = 128
  training.n_iters = 10001
  training.snapshot_freq = 5000
  training.log_freq = 50
  training.eval_freq = 100
  training.snapshot_freq_for_preemption = 10000
  training.snapshot_sampling = True
  training.likelihood_weighting = False
  training.continuous = True
  training.reduce_mean = False

  # sampling
  config.sampling = sampling = ConfigDict()
  sampling.n_steps_each = 1
  sampling.noise_removal = True
  sampling.probability_flow = False
  sampling.snr = 0.16

  # evaluation
  config.eval = evaluate = ConfigDict()
  evaluate.begin_ckpt = 9
  evaluate.end_ckpt = 26
  evaluate.batch_size = 1024
  evaluate.enable_sampling = False
  evaluate.num_samples = 50000
  evaluate.enable_loss = True
  evaluate.enable_bpd = False
  evaluate.bpd_dataset = 'test'
  evaluate.wait_for_ckpt = False

  # data
  config.data = data = ConfigDict()
  data.dataset = 'CIFAR10'
  data.image_size = 32
  data.random_flip = True
  data.centered = False
  data.uniform_dequantization = False
  data.num_channels = 3

  # model
  config.model = model = ConfigDict()
  model.sigma_min = 0.01
  model.sigma_max = 50
  model.num_scales = 1000
  model.beta_min = 0.1
  model.beta_max = 20.
  model.dropout = 0.1
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
  return add_execution_defaults(config)


def add_execution_defaults(config: ConfigDict) -> ConfigDict:
  """Execution block (JAX ``add_tpu_defaults`` minus the kernel switches)."""
  tpu = config.tpu = ConfigDict()
  tpu.data_axis = -1
  tpu.mesh_shape = (-1, 1)
  # Activations and conv/matmul inputs in bf16, parameters in f32.
  tpu.compute_dtype = 'bfloat16'
  tpu.param_dtype = 'float32'
  tpu.remat = False
  tpu.donate_state = True
  tpu.pinn_microbatch = 0
  tpu.steps_per_dispatch = 1
  config.device = 'cuda'
  if 'sampling' in config:
    config.sampling.dpm_steps = 20
    config.sampling.dpm_order = 2
    config.sampling.dpm_skip = 'logsnr'
    # The port's PC loop already dispatches step by step, so the JAX
    # chunking knob changes nothing here; kept for the same keys.
    config.sampling.pc_chunks = 0
  if 'eval' in config:
    config.eval.num_ref_images = 2048
    config.eval.inception_random_init = False
  return config


def add_inverse_extensions(inverse: ConfigDict) -> ConfigDict:
  """The solver keys of an ``inverse`` block (JAX
  ``add_inverse_extensions``): the ``fixed`` solver's steps and the
  guided DPM-Solver++'s steps, order and time grid."""
  inverse.fixed_steps = 5000
  inverse.dpm_steps = 50
  inverse.dpm_order = 2
  inverse.dpm_skip = 'logsnr'
  return inverse
