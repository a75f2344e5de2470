"""Stride-1 SAME 3x3 convolution plus bias (kernel K1), NHWC / HWIO.

Counterpart of the JAX package's ``ops/winograd.py`` ``conv3x3_fast`` and
the TPU kernel behind it, ``ops/winograd_pallas.py``
``winograd_conv3x3_fused``.  Winograd is an exact rewrite of the same
convolution; the card computes it as an implicit GEMM with one of two
kernels, picked by :func:`kernel_for` from the dtype and shape alone:

- ``'wgmma'`` (``csrc/conv3x3_wgmma.cu``): bf16 with Cin and Cout multiples
  of 8 (TMA needs 16-byte strides).  Tensor cores fed by TMA, tiles and
  split-K from :func:`wgmma_plan`.  Every bf16 site of the flagship U-Net.
- ``'direct'`` (``csrc/conv3x3.cu``): everything else, f32 above all (TF32
  would miss the f32 limit of 1e-4); f32 FMA on the CUDA cores.

:func:`conv3x3` takes the plain version, :func:`conv3x3_plain`, only for a
tensor on the CPU; for a CUDA tensor it launches a kernel or raises.
``conv3x3.launches`` counts every launch, ``conv3x3.launches_by_kernel``
each kernel's.
Both compute in f32 from inputs cast to ``x.dtype`` (weights too), add the
f32 bias, and return ``x.dtype`` — the JAX ``_direct_conv`` semantics.

Gradients (the JAX ``_fused_conv`` custom_vjp, whose backward is the vjp of
``_direct_conv``): for a stride-1 SAME 3x3 conv the data gradient is the
SAME 3x3 conv of dy with the kernel flipped in both spatial axes and its
channel axes swapped, ``W'[kh,kw,co,ci] = W[2-kh,2-kw,ci,co]``, and no bias;
on the card that conv is a launch of the same kernels (Cin and Cout
swapped in :func:`kernel_for`), counted in ``launches_by_use['data_grad']``,
and on the CPU it is :func:`conv3x3_plain` with the same ``W'``.  The
weight gradient is ``torch.nn.grad.conv2d_weight`` (cuDNN on the card): the
JAX package leaves that contraction to XLA, outside any Pallas kernel.
Gradients come out in ``x.dtype`` (data) and the parameters' dtypes.

Forward mode (``torch.func.jvp``, ``torch.autograd.forward_ad``): the
conv is bilinear in (x, W), so ``dy = K1(dx, W) + K1(x, dW) + db``, each
term only where its tangent is present; a K1 launch each on the card,
counted in ``launches_by_use['jvp']`` (the likelihood's divergence: one
launch on the tangent of x, no bias), the plain version on the CPU.  The
tangent comes out in ``x.dtype``, like the output.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    'conv3x3_nhwc': (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
                    + (ctypes.c_void_p,),
}
_WGMMA_SIGNATURES = {
    'conv3x3_wgmma_nhwc': (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 10
                          + (ctypes.c_void_p,),
}
# The wgmma kernel's fixed sizes (csrc/conv3x3_wgmma.cu): 64 output pixels
# and 64 input channels a K step per block, at most 8 blocks in a split-K
# cluster.  The plan aims at about one wave of the H100's 132 SMs.
WGMMA_BM = 64
WGMMA_BK = 64
MAX_SPLIT = 8
TARGET_BLOCKS = 128
MIN_STEPS_PER_SPLIT = 4   # a split keeps the 4-stage ring full


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


def kernel_for(dtype: torch.dtype, cin: int, cout: int) -> str:
  """The card's kernel for a conv, by dtype and shape only: ``'wgmma'``
  for bf16 with Cin and Cout multiples of 8, else ``'direct'``."""
  if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0:
    return 'wgmma'
  return 'direct'


def _pow2_ceil(n: int) -> int:
  return 1 << max(0, (n - 1).bit_length())


def wgmma_box(B: int, H: int, W: int) -> Tuple[int, int, int]:
  """The pixel box (bb, hb, wb) of one 64-pixel tile: whole rows of the
  image where they fit, bb * hb * wb = 64, each a power of two.  Rows past
  the image (odd H or W) are zeros on load and masked on store."""
  wb = min(_pow2_ceil(W), WGMMA_BM)
  hb = min(_pow2_ceil(H), WGMMA_BM // wb)
  return WGMMA_BM // (wb * hb), hb, wb


@functools.lru_cache(maxsize=None)
def wgmma_plan(B: int, H: int, W: int, cin: int, cout: int) -> Dict:
  """Tiles and split-K of the wgmma kernel.

  ``bn`` is 128 output channels where that still gives about one wave of
  blocks, else 64.  ``split`` doubles (up to 8, one cluster) while the
  blocks are fewer than ``TARGET_BLOCKS`` and every split keeps at least
  ``MIN_STEPS_PER_SPLIT`` of the 9 * ceil(Cin/64) K steps.
  """
  bb, hb, wb = wgmma_box(B, H, W)
  tiles_m = math.ceil(B / bb) * math.ceil(H / hb) * math.ceil(W / wb)
  bn = 128 if cout > 64 else 64
  if tiles_m * math.ceil(cout / bn) < TARGET_BLOCKS:
    bn = 64
  tiles = tiles_m * math.ceil(cout / bn)
  k_steps = 9 * math.ceil(cin / WGMMA_BK)
  split = 1
  while (split < MAX_SPLIT and tiles * split < TARGET_BLOCKS
         and k_steps >= MIN_STEPS_PER_SPLIT * split * 2):
    split *= 2
  return dict(box=(bb, hb, wb), bn=bn, tiles_m=tiles_m,
              tiles_n=math.ceil(cout / bn), split=split, k_steps=k_steps,
              blocks=tiles * split)


def conv_nhwc_plain(x: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, stride: int = 1,
                    padding: int = 0, dilation: int = 1) -> torch.Tensor:
  """NHWC/HWIO conv by ``F.conv2d`` on an NCHW view, in f32 (f64 for f64
  inputs) from inputs cast to ``x.dtype``; bias likewise; output in
  ``x.dtype``."""
  dtype = x.dtype
  compute = torch.promote_types(dtype, torch.float32)
  w = kernel.to(dtype).to(compute).permute(3, 2, 0, 1)     # HWIO -> OIHW
  if compute == torch.float64 or x.device.type == 'cpu':
    # The CPU's slow convolution (f64; f32 at batch 1) refuses a strided
    # weight in its backward ("grad_weight must be contiguous").
    w = w.contiguous()
  out = F.conv2d(x.to(compute).permute(0, 3, 1, 2), w, stride=stride,
                 padding=padding, dilation=dilation).permute(0, 2, 3, 1)
  if bias is not None:
    out = out + bias.to(compute)
  return out.to(dtype).contiguous()


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Plain PyTorch version of :func:`conv3x3`."""
  return conv_nhwc_plain(x, kernel, bias, padding=1)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """x (B,H,W,Cin), kernel (3,3,Cin,Cout), bias (Cout,) -> (B,H,W,Cout).

  f32 or bf16 ``x``; f32 accumulation; output in ``x.dtype``.
  Differentiable once in each input, in reverse and in forward mode (see
  the module docstring).
  """
  if _build.differentiated(x, kernel, bias):
    return _Conv3x3.apply(x, kernel, bias, 'forward')
  return _conv(x, kernel, bias, 'forward')


def flipped(kernel: torch.Tensor) -> torch.Tensor:
  """``W'[kh,kw,co,ci] = W[2-kh,2-kw,ci,co]``: the kernel whose SAME conv
  of dy is the data gradient of the SAME conv with ``kernel``."""
  return kernel.flip(0, 1).transpose(2, 3)


class _Conv3x3(torch.autograd.Function):
  """K1 (``use`` names the launch's count) with its backward (dx by K1 on
  :func:`flipped` weights, dW by ``conv2d_weight``, db by a sum: JAX
  ``_fused_conv_bwd``) and its forward-mode rule (K1 on each tangent).

  Under ``torch.func.jvp`` the rule gets functorch's wrapped tensors,
  whose data a launch cannot read; so each of its terms is this Function
  again, whose forward gets the unwrapped ones, on x stripped of its
  tangent (no term of second order is formed) and on detached tensors:
  the tangent is not differentiated again (the backward is once
  differentiable), so no graph holds its activations."""

  @staticmethod
  def forward(x, kernel, bias, use):
    return _conv(x, kernel, bias, use)

  @staticmethod
  def setup_context(ctx, inputs, output):
    x, kernel, bias, _ = inputs
    ctx.set_materialize_grads(False)    # a missing tangent comes as None
    ctx.save_for_backward(x, kernel)
    ctx.save_for_forward(x, kernel)
    ctx.bias_dtype = None if bias is None else bias.dtype

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, dy):
    x, kernel = ctx.saved_tensors
    dx = dk = db = None
    dy = dy.to(x.dtype)
    if ctx.needs_input_grad[0]:
      dx = _conv(dy, flipped(kernel), None, 'data_grad')
    if ctx.needs_input_grad[1]:
      dk = torch.nn.grad.conv2d_weight(
          x.permute(0, 3, 1, 2), (kernel.shape[3], kernel.shape[2], 3, 3),
          dy.permute(0, 3, 1, 2), padding=1)
      dk = dk.permute(2, 3, 1, 0).to(kernel.dtype)        # OIHW -> HWIO
    if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
      db = dy.float().sum((0, 1, 2)).to(ctx.bias_dtype)
    return dx, dk, db, None

  @staticmethod
  def jvp(ctx, dx, dk, db, _):
    x, kernel = (fwAD.unpack_dual(t).primal.detach()
                 for t in ctx.saved_tensors)
    terms = []
    if dx is not None:
      terms.append(_Conv3x3.apply(dx.detach().to(x.dtype), kernel, None,
                                  'jvp'))
    if dk is not None:
      terms.append(_Conv3x3.apply(x, dk.detach(), None, 'jvp'))
    if not terms:
      terms.append(x.new_zeros(x.shape[:3] + kernel.shape[3:]))
    dy = terms[0] if len(terms) == 1 else terms[0] + terms[1]
    if db is not None:
      dy = (dy.float() + db.detach().float()).to(x.dtype)
    return dy


def _conv(x: torch.Tensor, kernel: torch.Tensor,
          bias: Optional[torch.Tensor], use: str) -> torch.Tensor:
  """The forward of :func:`conv3x3` (``use`` 'forward'), its data
  gradient ('data_grad') or a term of its tangent ('jvp'): the plain
  version for a CPU tensor, else a kernel launch."""
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

  return _launch(kernel_for(x.dtype, Cin, Cout), x, kernel, bias, use)


def _conv3x3_direct(x: torch.Tensor, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
  """The direct kernel on any CUDA input, whatever :func:`kernel_for` would
  pick: the yardstick ``chip_smoke.py`` times beside the wgmma kernel.  The
  main path never calls it."""
  return _launch('direct', x, kernel, bias)


def _launch(which: str, x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor], use: str = 'forward'
            ) -> torch.Tensor:
  B, H, W, Cin = x.shape
  Cout = kernel.shape[3]
  x = x.contiguous()
  w = kernel.to(x.dtype).contiguous()
  b = (torch.zeros(Cout, dtype=torch.float32, device=x.device)
       if bias is None else bias.float().contiguous())
  y = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
  stream = torch.cuda.current_stream(x.device).cuda_stream
  if which == 'wgmma':
    # TMA reads from 16-byte aligned addresses; a view may start elsewhere.
    x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))
    plan = wgmma_plan(B, H, W, Cin, Cout)
    lib = _build.load('conv3x3_wgmma', _WGMMA_SIGNATURES)
    err = lib.conv3x3_wgmma_nhwc(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                 y.data_ptr(), B, H, W, Cin, Cout, plan['bn'],
                                 *plan['box'], plan['split'], stream)
  else:
    lib = _build.load('conv3x3', _SIGNATURES)
    err = lib.conv3x3_nhwc(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                           y.data_ptr(), B, H, W, Cin, Cout,
                           _DTYPE_CODES[x.dtype], stream)
  _build.check_launch(err, f'conv3x3 ({which})')
  conv3x3.launches += 1
  conv3x3.launches_by_kernel[which] += 1
  conv3x3.launches_by_use[use] += 1
  return y


conv3x3.launches = 0
conv3x3.launches_by_kernel = {'wgmma': 0, 'direct': 0}
conv3x3.launches_by_use = {'forward': 0, 'data_grad': 0, 'jvp': 0}
