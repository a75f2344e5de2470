"""Stride-1 SAME 3x3 convolution plus bias (kernel K1), NHWC / HWIO.

Counterpart of the JAX package's ``ops/winograd.py`` ``conv3x3_fast`` and
the TPU kernel behind it, ``ops/winograd_pallas.py``
``winograd_conv3x3_fused``.  The card's kernel is ``csrc/conv3x3.cu`` (a
direct implicit GEMM; Winograd is an exact rewrite of the same
convolution).

:func:`conv3x3` takes the plain version, :func:`conv3x3_plain`, only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Both compute in f32 from inputs cast to ``x.dtype`` (weights too), add the
f32 bias, and return ``x.dtype`` — the JAX ``_direct_conv`` semantics.
Forward only: the backward comes with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    'conv3x3_nhwc': (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
                    + (ctypes.c_void_p,),
}


def applicable(x_shape, kernel_shape, stride: int = 1, dilation: int = 1,
               min_channels: int = 32) -> bool:
  """Which convs go to the kernel: the JAX ``winograd_applicable`` guard
  (stride 1, dilation 1, 3x3, at least 32 input and output channels).

  The U-Net's first conv (3 input channels) and last conv (3 output
  channels) fail it and stay on the plain path, as they stay on the direct
  conv in JAX.
  """
  return (stride == 1 and dilation == 1
          and tuple(kernel_shape[:2]) == (3, 3)
          and x_shape[-1] >= min_channels
          and kernel_shape[-1] >= min_channels)


def conv_nhwc_plain(x: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, stride: int = 1,
                    padding: int = 0) -> torch.Tensor:
  """NHWC/HWIO conv by ``F.conv2d`` on an NCHW view, in f32 from inputs
  cast to ``x.dtype``; f32 bias; output in ``x.dtype``."""
  dtype = x.dtype
  w = kernel.to(dtype).float().permute(3, 2, 0, 1)          # HWIO -> OIHW
  out = F.conv2d(x.float().permute(0, 3, 1, 2), w, stride=stride,
                 padding=padding).permute(0, 2, 3, 1)
  if bias is not None:
    out = out + bias.float()
  return out.to(dtype).contiguous()


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Plain PyTorch version of :func:`conv3x3`."""
  return conv_nhwc_plain(x, kernel, bias, padding=1)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """x (B,H,W,Cin), kernel (3,3,Cin,Cout), bias (Cout,) -> (B,H,W,Cout).

  f32 or bf16 ``x``; f32 accumulation; output in ``x.dtype``.
  """
  _build.forward_only('conv3x3', x, kernel, bias)
  if x.device.type == 'cpu':
    return conv3x3_plain(x, kernel, bias)
  if x.device.type != 'cuda':
    raise ValueError(f'conv3x3: no kernel for device {x.device}')
  if x.ndim != 4 or kernel.ndim != 4 or tuple(kernel.shape[:3]) != (
      3, 3, x.shape[-1]):
    raise ValueError(f'conv3x3: x {tuple(x.shape)} and kernel '
                     f'{tuple(kernel.shape)} are not NHWC and (3,3,Cin,Cout)')
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f'conv3x3: dtype {x.dtype} not supported')
  B, H, W, Cin = x.shape
  Cout = kernel.shape[3]
  if bias is not None and tuple(bias.shape) != (Cout,):
    raise ValueError(f'conv3x3: bias {tuple(bias.shape)} is not ({Cout},)')
  if max(x.numel(), B * H * W * Cout, 9 * Cin * Cout) >= 2 ** 31:
    raise ValueError('conv3x3: tensor too large for 32-bit indexing')
  for t in (kernel, bias):
    if t is not None and t.device != x.device:
      raise ValueError('conv3x3: x, kernel and bias must share a device')

  x = x.contiguous()
  w = kernel.to(x.dtype).contiguous()
  b = (torch.zeros(Cout, dtype=torch.float32, device=x.device)
       if bias is None else bias.float().contiguous())
  y = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
  lib = _build.load('conv3x3', _SIGNATURES)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  err = lib.conv3x3_nhwc(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         y.data_ptr(), B, H, W, Cin, Cout,
                         _DTYPE_CODES[x.dtype], stream)
  _build.check_launch(err, 'conv3x3')
  conv3x3.launches += 1
  return y


conv3x3.launches = 0
