"""Config registry: copies of the JAX package's configs, same keys.

Usage:
    from b_pinn_kalman_filter_tpu_torch import configs
    cfg = configs.get_config("vp/cifar10_ddpmpp_continuous")

The configs of the ported paths: the flagship, ``pinn/pinn_pde`` (the
FlowNet-PINN), ``pinn/pinn_pde_lfn`` (the LiteFlowNet-PINN),
``vp/nc_ddpmpp`` (trained by the discrete DDPM loss) with its three
``inverse/`` configs, and the fifteen NCSN++ configs: ``{ve,vp}/
cifar10_ncsnpp``, ``{ve,vp,subvp}/cifar10_ncsnpp{,_deep}_continuous``,
``ve/celeba_ncsnpp`` and ``ve/{celebahq,celebahq_256,ffhq,ffhq_256,
church,bedroom}_ncsnpp_continuous``.
"""

import importlib


def get_config(name: str):
  """Load a config by its reference-style relative path (no .py suffix)."""
  if name.endswith(".py"):
    name = name[:-3]
  name = name.replace("/", ".")
  mod = importlib.import_module(f"{__name__}.{name}")
  return mod.get_config()
