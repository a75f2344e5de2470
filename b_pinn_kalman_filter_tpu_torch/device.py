"""Device and dtype selection.

Entry points run on the card unless the caller asks for the CPU.  There is
no silent fallback: asking for the default device on a machine without CUDA
raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {
    'float32': torch.float32,
    'bfloat16': torch.bfloat16,
}


def get_device(device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
  """``device`` as a ``torch.device``; ``None`` means ``cuda``.

  Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
  default) and CUDA is not available.
  """
  device = torch.device('cuda' if device is None else device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'CUDA is not available; pass device="cpu" to run on the CPU')
  return device


def get_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
  """Compute dtype from a config string such as ``'bfloat16'``."""
  if isinstance(name, torch.dtype):
    return name
  try:
    return _DTYPES[name]
  except KeyError:
    raise ValueError(f'unknown dtype {name!r}') from None
