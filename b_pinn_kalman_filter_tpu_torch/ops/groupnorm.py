"""Fused ``act(GroupNorm(x))`` (kernel K2), NHWC.

Counterpart of the JAX package's ``ops/groupnorm_pallas.py``
``groupnorm_act``.  The card's kernel is ``csrc/groupnorm.cu``: a cluster
of up to 8 blocks per image that reads the image once, keeps its slice in
shared memory, and combines the group statistics through distributed
shared memory; :func:`groupnorm_plan` sizes it.

:func:`groupnorm_act` takes the plain version, :func:`groupnorm_act_plain`,
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.  Statistics are f32, scale and bias f32, output in ``x.dtype``.

Gradients, as the JAX custom_vjp takes them: the forward is the kernel,
the backward recomputes through :func:`groupnorm_act_plain` and returns its
vjp, on every device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.ops import _build

ACTS = {'none': 0, 'silu': 1, 'elu': 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    'groupnorm_act_nhwc': (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                          + (ctypes.c_float,) + (ctypes.c_int,) * 7
                          + (ctypes.c_void_p,),
}
_PERGROUP_SIGNATURES = {
    'groupnorm_act_pergroup_nhwc': (ctypes.c_void_p,) * 4
                                   + (ctypes.c_int,) * 5
                                   + (ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p),
}
# csrc/groupnorm.cu's sizes: 256 or 512 threads a block, at most 8 blocks
# (a portable cluster) per image, and the H100's 227 KB of shared memory a
# block.
THREADS = 512
SMALL_THREADS = 256
MAX_CLUSTER = 8
SMEM_LIMIT = 232448
MIN_SLICE_BYTES = 16 * 1024   # a block's least share of an image


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


@functools.lru_cache(maxsize=None)
def groupnorm_plan(H: int, W: int, C: int, G: int, itemsize: int) -> Dict:
  """How csrc/groupnorm.cu covers one image of (H, W, C).

  ``cluster``: blocks per image, a power of two up to 8, doubled while
  every block keeps a pixel and at least ``MIN_SLICE_BYTES`` of the image
  (below that the cluster's barriers cost more than the loads they
  spread).  ``vec``: channels a load, 16 bytes' worth where C * itemsize
  is a multiple of 16, else 1.  ``threads``: 256 where a block's slice is
  at most ``MIN_SLICE_BYTES`` (latency-bound), else 512.  ``q``: the
  thread columns (vectors of one pixel read side by side), the rest of
  the threads being rows.  ``on_chip``: whether a block's slice of
  ceil(H*W / cluster) pixels fits in shared memory beside the statistics
  (else the kernel reads it again for its later passes).
  """
  P = H * W
  cluster = 1
  while (cluster < MAX_CLUSTER and 2 * cluster <= P
         and P * C * itemsize // (2 * cluster) >= MIN_SLICE_BYTES):
    cluster *= 2
  vec = 16 // itemsize if (C * itemsize) % 16 == 0 else 1
  slice_bytes = math.ceil(P / cluster) * C * itemsize
  threads = SMALL_THREADS if slice_bytes <= MIN_SLICE_BYTES else THREADS
  q = min(C // vec, threads)
  rows = threads // q
  stat_bytes = 4 * ((rows * C + 5 * C + 2 * G + 3) // 4 * 4)
  on_chip = stat_bytes + slice_bytes <= SMEM_LIMIT
  smem = stat_bytes + (slice_bytes if on_chip else 0)
  return dict(cluster=cluster, threads=threads, vec=vec, q=q,
              on_chip=on_chip, smem_bytes=smem, slice_bytes=slice_bytes)


def groupnorm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  num_groups: int = 32, act: str = 'silu',
                  eps: float = 1e-6) -> torch.Tensor:
  """x (B,H,W,C) -> act(GroupNorm(x)), same shape and dtype.

  Differentiable once in ``x``, ``scale`` and ``bias``.  A tensor with a
  forward-mode tangent takes the plain version on the CPU and raises on
  the card (ROADMAP.md B.3).
  """
  _build.tangents('groupnorm_act', x, scale, bias)
  if torch.is_grad_enabled() and any(
      t.requires_grad for t in (x, scale, bias)):
    return _GroupNormAct.apply(x, scale, bias, num_groups, act, eps)
  return _groupnorm_act(x, scale, bias, num_groups, act, eps)


class _GroupNormAct(torch.autograd.Function):
  """K2 forward; backward by recomputing the plain version (JAX
  ``_groupnorm_act_bwd``)."""

  @staticmethod
  def forward(ctx, x, scale, bias, num_groups, act, eps):
    ctx.save_for_backward(x, scale, bias)
    ctx.args = (num_groups, act, eps)
    return _groupnorm_act(x, scale, bias, num_groups, act, eps)

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, dy):
    inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
    with torch.enable_grad():
      y = groupnorm_act_plain(*inputs, *ctx.args)
    return torch.autograd.grad(y, inputs, dy) + (None, None, None)


def _groupnorm_act(x, scale, bias, num_groups, act, eps):
  """The forward: the plain version for a CPU tensor, else the kernel."""
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

  plan = groupnorm_plan(H, W, C, num_groups, x.element_size())
  if plan['smem_bytes'] > SMEM_LIMIT:
    raise ValueError(f'groupnorm_act: C = {C} needs {plan["smem_bytes"]} '
                     'bytes of shared memory for its statistics')
  x, s, b, y, stream = _operands(x, scale, bias)
  if x.data_ptr() % 16:
    x = x.clone()    # a view may start off the 16-byte vector grid
  lib = _build.load('groupnorm', _SIGNATURES)
  err = lib.groupnorm_act_nhwc(
      x.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(), B, H * W, C,
      num_groups, ACTS[act], eps, _DTYPE_CODES[x.dtype], plan['cluster'],
      plan['threads'], plan['vec'], plan['q'], int(plan['on_chip']),
      plan['smem_bytes'], stream)
  _build.check_launch(err, 'groupnorm_act')
  groupnorm_act.launches += 1
  return y


def _operands(x, scale, bias):
  x = x.contiguous()
  return (x, scale.float().contiguous(), bias.float().contiguous(),
          torch.empty_like(x), torch.cuda.current_stream(x.device).cuda_stream)


def _groupnorm_act_pergroup(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, num_groups: int = 32,
                            act: str = 'silu', eps: float = 1e-6
                            ) -> torch.Tensor:
  """The first port's kernel (csrc/groupnorm_pergroup.cu, one block per
  image and group) on a CUDA tensor: the yardstick ``chip_smoke.py`` times
  beside :func:`groupnorm_act`.  The main path never calls it."""
  B, H, W, C = x.shape
  x, s, b, y, stream = _operands(x, scale, bias)
  lib = _build.load('groupnorm_pergroup', _PERGROUP_SIGNATURES)
  err = lib.groupnorm_act_pergroup_nhwc(
      x.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(), B, H * W, C,
      num_groups, ACTS[act], eps, _DTYPE_CODES[x.dtype], stream)
  _build.check_launch(err, 'groupnorm_act (per group)')
  return y


groupnorm_act.launches = 0
