"""Config registry: copies of the JAX package's configs, same keys.

Usage:
    from b_pinn_kalman_filter_tpu_torch import configs
    cfg = configs.get_config("vp/cifar10_ddpmpp_continuous")

Every config of the JAX package's tree but ``tpu_defaults.py`` (its TPU
defaults): the DDPM, DDPM++, NCSN++, NCSN and NCSNv2 score models under
``vp/``, ``subvp/`` and ``ve/``, the PINNs under ``pinn/`` and the
inverse problems under ``inverse/``.
"""

import importlib


def get_config(name: str):
  """Load a config by its reference-style relative path (no .py suffix)."""
  if name.endswith(".py"):
    name = name[:-3]
  name = name.replace("/", ".")
  mod = importlib.import_module(f"{__name__}.{name}")
  return mod.get_config()
