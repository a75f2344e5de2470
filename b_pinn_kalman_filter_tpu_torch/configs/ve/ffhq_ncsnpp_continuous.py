"""NCSN++ on FFHQ 1024x1024, continuous VE (copy of the JAX package's
``configs/ve/ffhq_ncsnpp_continuous.py``; same keys and values)."""

from b_pinn_kalman_filter_tpu_torch.configs.ve import (
    celebahq_ncsnpp_continuous)


def get_config():
  return celebahq_ncsnpp_continuous._highres_1024('FFHQ', reduce_mean=True)
