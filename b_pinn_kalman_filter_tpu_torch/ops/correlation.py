"""FlowNet-style local correlation cost volume, NHWC.

Counterpart of the JAX package's ``ops/correlation.py`` ``correlation`` and
of the TPU kernel ``ops/correlation_pallas.py`` ``correlation_pallas``
(kernel K3), whose card version is ``csrc/correlation.cu``.  For (dy, dx)
in [-3, 3]^2 scaled by ``stride``::

    out[b, yo, xo, (dy+3)*7 + (dx+3)]
      = mean_c f1[b, c, yo*s, xo*s] * f2[b, c, yo*s + dy*s, xo*s + dx*s]

with f2 zero outside the image and output size ceil(H/s) x ceil(W/s).

:func:`correlation` launches the kernel for stride 1 on a CUDA tensor (or
raises) and takes the plain version, :func:`correlation_plain`, for a CPU
tensor; stride > 1 always takes the plain version, as the JAX dispatch
does.  The kernel is forward only: its backward comes with PINN training.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.ops import _build

_D = 3   # maximum displacement (7x7 window)
_SIGNATURES = {
    'correlation_f32': (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
                       + (ctypes.c_void_p,),
}


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor,
                      stride: int = 1) -> torch.Tensor:
  """Plain PyTorch version: (B, H, W, C) x 2 -> (B, ceil(H/s), ceil(W/s),
  49)."""
  B, H, W, C = f1.shape
  s = int(stride)
  pad = _D * s
  f2p = F.pad(f2, (0, 0, pad, pad, pad, pad))
  f1s = f1[:, ::s, ::s, :]
  outs = []
  for dy in range(-_D, _D + 1):
    for dx in range(-_D, _D + 1):
      oy = pad + dy * s
      ox = pad + dx * s
      shifted = f2p[:, oy:oy + H, ox:ox + W, :][:, ::s, ::s, :]
      outs.append((f1s * shifted).mean(dim=-1))
  return torch.stack(outs, dim=-1)


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
  """Cost volume of f1 against f2, (B, H, W, C) float32 each."""
  if stride != 1:
    return correlation_plain(f1, f2, stride)
  _build.forward_only('correlation', f1, f2)
  if f1.device.type == 'cpu':
    return correlation_plain(f1, f2)
  if f1.device.type != 'cuda':
    raise ValueError(f'correlation: no kernel for device {f1.device}')
  if f1.ndim != 4 or f1.shape != f2.shape:
    raise ValueError(f'correlation: f1 {tuple(f1.shape)} and f2 '
                     f'{tuple(f2.shape)} must share one (B, H, W, C) shape')
  if f1.dtype != torch.float32 or f2.dtype != torch.float32:
    raise TypeError('correlation: the kernel takes float32 features')
  if f2.device != f1.device:
    raise ValueError('correlation: f1 and f2 must share a device')
  B, H, W, C = f1.shape
  if f1.numel() == 0:
    raise ValueError(f'correlation: empty input {tuple(f1.shape)}')
  if max(f1.numel(), B * H * W * 49) >= 2 ** 31:
    raise ValueError('correlation: tensor too large for 32-bit indexing')

  f1 = f1.contiguous()
  f2 = f2.contiguous()
  out = torch.empty((B, H, W, (2 * _D + 1) ** 2), dtype=torch.float32,
                    device=f1.device)
  lib = _build.load('correlation', _SIGNATURES)
  stream = torch.cuda.current_stream(f1.device).cuda_stream
  err = lib.correlation_f32(f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                            B, H, W, C, stream)
  _build.check_launch(err, 'correlation')
  correlation.launches += 1
  return out


correlation.launches = 0
