"""PINN set-up and training loops.  So far only ``init_pinn``; training
comes with a later slice.  Counterpart of the JAX package's
``pinn/pinn_lib.py``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN


def init_pinn(config, seed: Optional[int] = None, device=None
              ) -> Tuple[PINN, Dict[str, Dict[str, torch.Tensor]]]:
  """The PINN on ``device`` (default ``cuda``) in eval mode, its
  parameters drawn by the flax inits from a CPU generator seeded with
  ``seed`` (default ``config.seed``).  Returns ``(model, params)`` with
  params ``{'flownet': {name: tensor}, 'pressurenet': {...}}``, the shape
  of the JAX ``variables['params']``."""
  device = get_device(device)
  model = PINN(config)
  seed = config.seed if seed is None else seed
  layers.init_params(model, torch.Generator().manual_seed(seed))
  model = model.to(device).eval()
  params = {key: {name: p.detach()
                  for name, p in getattr(model, key).named_parameters()}
            for key in ('flownet', 'pressurenet')}
  return model, params
