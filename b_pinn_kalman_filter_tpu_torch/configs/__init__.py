"""Config registry: copies of the JAX package's configs, same keys.

Usage:
    from b_pinn_kalman_filter_tpu_torch import configs
    cfg = configs.get_config("vp/cifar10_ddpmpp_continuous")

The configs of the ported paths: the flagship, ``pinn/pinn_pde``, and
``vp/nc_ddpmpp`` with its three ``inverse/`` configs.
"""

import importlib


def get_config(name: str):
  """Load a config by its reference-style relative path (no .py suffix)."""
  if name.endswith(".py"):
    name = name[:-3]
  name = name.replace("/", ".")
  mod = importlib.import_module(f"{__name__}.{name}")
  return mod.get_config()
