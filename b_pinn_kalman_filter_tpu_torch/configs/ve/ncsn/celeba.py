"""NCSNv1 on CelebA, original annealing (copy of the JAX package's
``configs/ve/ncsn/celeba.py``; same keys and values).

Reference quirk, corrected: the reference sets ``training.loss = 'vesde'``
(a typo for ``training.sde``, reference ve/ncsn/celeba.py:26) which would
leave ``training.sde`` undefined and crash its own run_lib.  The JAX
package sets ``training.sde`` so the config is actually runnable.
"""

from b_pinn_kalman_filter_tpu_torch.configs._blocks import (
    ncsn_model, ncsn_optim)
from b_pinn_kalman_filter_tpu_torch.configs.default_celeba_configs import (
    get_default_configs)


def get_config():
  config = get_default_configs()
  training = config.training
  training.sde = 'vesde'
  training.continuous = False

  sampling = config.sampling
  sampling.method = 'pc'
  sampling.predictor = 'none'
  sampling.corrector = 'ald'
  sampling.n_steps_each = 100
  sampling.snr = 0.316

  ncsn_model(config.model)
  config.model.sigma_max = 1
  config.model.num_scales = 10
  config.model.ema_rate = 0.

  ncsn_optim(config.optim)
  return config
