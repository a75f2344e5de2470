"""Fused ``act(GroupNorm(x))`` (kernel K2), NHWC.

Counterpart of the JAX package's ``ops/groupnorm_pallas.py``
``groupnorm_act``.  The card's kernel is ``csrc/groupnorm.cu``.

:func:`groupnorm_act` takes the plain version, :func:`groupnorm_act_plain`,
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.  Statistics are f32, scale and bias f32, output in ``x.dtype``.
Forward only: the backward comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.ops import _build

ACTS = {'none': 0, 'silu': 1, 'elu': 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    'groupnorm_act_nhwc': (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                          + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p),
}


def groupnorm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, num_groups: int = 32,
                        act: str = 'silu', eps: float = 1e-6
                        ) -> torch.Tensor:
  """Plain PyTorch version (JAX ``_reference_groupnorm_act``)."""
  B, H, W, C = x.shape
  g = x.float().reshape(B, H * W, num_groups, C // num_groups)
  mean = g.mean(dim=(1, 3), keepdim=True)
  var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
  g = (g - mean) * torch.rsqrt(var + eps)
  y = g.reshape(B, H, W, C) * scale.float() + bias.float()
  if act == 'silu':
    y = F.silu(y)
  elif act == 'elu':
    y = F.elu(y)
  elif act != 'none':
    raise ValueError(f'unknown activation {act!r}')
  return y.to(x.dtype)


def groupnorm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  num_groups: int = 32, act: str = 'silu',
                  eps: float = 1e-6) -> torch.Tensor:
  """x (B,H,W,C) -> act(GroupNorm(x)), same shape and dtype."""
  _build.forward_only('groupnorm_act', x, scale, bias)
  if x.device.type == 'cpu':
    return groupnorm_act_plain(x, scale, bias, num_groups, act, eps)
  if x.device.type != 'cuda':
    raise ValueError(f'groupnorm_act: no kernel for device {x.device}')
  if x.ndim != 4:
    raise ValueError(f'groupnorm_act: x {tuple(x.shape)} is not NHWC')
  B, H, W, C = x.shape
  if num_groups <= 0 or C % num_groups:
    raise ValueError(f'groupnorm_act: {num_groups} groups do not divide {C}')
  if act not in ACTS:
    raise ValueError(f'unknown activation {act!r}')
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f'groupnorm_act: dtype {x.dtype} not supported')
  if tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,):
    raise ValueError(f'groupnorm_act: scale and bias must be ({C},)')
  if x.numel() >= 2 ** 31:
    raise ValueError('groupnorm_act: tensor too large for 32-bit indexing')
  if scale.device != x.device or bias.device != x.device:
    raise ValueError('groupnorm_act: x, scale and bias must share a device')

  x = x.contiguous()
  s = scale.float().contiguous()
  b = bias.float().contiguous()
  y = torch.empty_like(x)
  lib = _build.load('groupnorm', _SIGNATURES)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  err = lib.groupnorm_act_nhwc(x.data_ptr(), s.data_ptr(), b.data_ptr(),
                               y.data_ptr(), B, H * W, C, num_groups,
                               ACTS[act], eps, _DTYPE_CODES[x.dtype], stream)
  _build.check_launch(err, 'groupnorm_act')
  groupnorm_act.launches += 1
  return y


groupnorm_act.launches = 0
