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

Forward mode (``torch.func.jvp``, ``torch.autograd.forward_ad``; the
likelihood's divergence): per (image, group) of n elements, with mu, r =
1/sqrt(var + eps) and xh = (x - mu) r as the forward has them, m1 =
mean(dx) and m2 = mean(xh dx), the tangent of xh is r (dx - m1 - xh m2);
then dz = scale dxh + dscale xh + dbias and dy = act'(z) dz, z = scale xh
+ bias.  On the card that is the kernel ``csrc/groupnorm_jvp.cu``
(:func:`groupnorm_act_jvp`, counted in ``groupnorm_act_jvp.launches``;
:func:`jvp_plan` sizes it), which streams x and dx in through the TMA,
takes the statistics in one shifted pass, and writes dy alone: the
Function's forward gave y by a K2 launch.  On the CPU it is
:func:`groupnorm_act_jvp_plain`.  The first card design of the JVP,
``csrc/groupnorm_jvp_cluster.cu`` on K2's plan, stays as the yardstick
``chip_smoke.py`` times beside it (:func:`_groupnorm_act_jvp_cluster`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.ops import _build

ACTS = {'none': 0, 'silu': 1, 'elu': 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    'groupnorm_act_nhwc': (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                          + (ctypes.c_float,) + (ctypes.c_int,) * 7
                          + (ctypes.c_void_p,),
}
_JVP_SIGNATURES = {
    'groupnorm_act_jvp_nhwc': (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
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
# csrc/groupnorm_jvp.cu's sizes: 256 threads a block, ring stages of at
# most 8 KB of x (and as much of dx), at most 32 of them, and two blocks an
# SM: an SM's 233,472 bytes of shared memory, less 1 KB the card keeps for
# each block, halved.
JVP_THREADS = 256
JVP_CHUNK_BYTES = 8 * 1024
JVP_MAX_STAGES = 32
SM_SMEM = 233472
BLOCK_RESERVED = 1024
NUM_SMS = 132
JVP_BLOCK_SMEM = SM_SMEM // 2 - BLOCK_RESERVED


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


def _cluster_jvp_plan(H: int, W: int, C: int, G: int, itemsize: int) -> Dict:
  """How the first card design of the JVP (csrc/groupnorm_jvp_cluster.cu,
  the yardstick) covers one image: K2's cluster, threads, vector width and
  thread columns (:func:`groupnorm_plan`), so that its sums of x run in
  K2's order; ``on_chip`` where a block's slices of x and of dx both fit
  beside its statistics (one plane of per-row sums and 10 C + 4 G floats),
  else it reads them again for its later passes."""
  plan = dict(groupnorm_plan(H, W, C, G, itemsize))
  rows = plan['threads'] // plan['q']
  stat_bytes = 4 * ((rows * C + 10 * C + 4 * G + 3) // 4 * 4)
  on_chip = stat_bytes + 2 * plan['slice_bytes'] <= SMEM_LIMIT
  plan.update(on_chip=on_chip, smem_bytes=stat_bytes + (
      2 * plan['slice_bytes'] if on_chip else 0))
  return plan


def _round_up(n: int, m: int) -> int:
  return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def jvp_plan(H: int, W: int, C: int, G: int, itemsize: int,
             B: int = 1) -> Dict:
  """How csrc/groupnorm_jvp.cu covers a batch of B images of (H, W, C).

  ``vec``: channels a load, 16 bytes' worth where C * itemsize is a
  multiple of 16 (then the TMA streams the slices), else 1.  ``q`` thread
  columns and ``rows_in_flight`` = 256 // q rows of them.  ``cluster``:
  blocks an image, the least power of two up to 8 whose ring holds a
  block's slices of x and dx in ``JVP_BLOCK_SMEM`` beside the plane and
  statistics (``head_bytes``), so that two blocks fit on an SM, else 8;
  then doubled while the grid stays within one wave of the 132 SMs and a
  block keeps ``MIN_SLICE_BYTES`` of x and dx.  (On an H100 at the
  flagship's sites the least cluster was the fastest at batch 256, and
  more blocks shortened the chain at batch 8; one block an image at 16x16
  and below, which keeps no such slice on chip, took up to 3x the first
  design's time there: ``scripts/kernel_plans_chip.py``, PERF.md §6.)  ``rows``: pixels a block;
  ``chunk_rows``: pixels a chunk (8 KB of x at most); ``stages``: ring
  stages of x and dx, as many chunks as fit; ``on_chip``: the ring holds
  the block's slice (else its output pass streams it again).  ``blocks``:
  the grid, cluster x B.
  """
  P = H * W
  vec = 16 // itemsize if (C * itemsize) % 16 == 0 else 1
  tpp = C // vec
  if tpp > JVP_THREADS:
    raise ValueError(f'groupnorm_act_jvp: C = {C} has more than '
                     f'{JVP_THREADS} vectors a pixel')
  q = tpp
  rows_in_flight = JVP_THREADS // q
  # The plane [2][rows_in_flight][C], the group sums, statistics and
  # shifts (9 G), then the mbarriers.
  head = (_round_up(4 * (2 * rows_in_flight * C + 9 * G), 128)
          + _round_up(8 * JVP_MAX_STAGES, 128))
  budget = JVP_BLOCK_SMEM - head
  pixel_bytes = C * itemsize

  def ring(cluster):
    """(rows, chunk_rows, chunks, stage bytes) of a block of ``cluster``."""
    rows = math.ceil(P / cluster)
    chunk_rows = max(1, min(rows, JVP_CHUNK_BYTES // pixel_bytes))
    return (rows, chunk_rows, math.ceil(rows / chunk_rows),
            _round_up(chunk_rows * pixel_bytes, 128))

  cluster = 1
  while cluster < MAX_CLUSTER and 2 * cluster <= P:
    _, _, chunks, stage_bytes = ring(cluster)
    if 2 * chunks * stage_bytes <= budget:
      break
    cluster *= 2
  # A grid short of a wave (the flagship's batch 8) spreads an image over
  # more blocks while each keeps MIN_SLICE_BYTES of x and dx.
  while (cluster < MAX_CLUSTER and 2 * cluster <= P
         and 2 * B * cluster <= NUM_SMS
         and 2 * math.ceil(P / (2 * cluster)) * pixel_bytes
         >= MIN_SLICE_BYTES):
    cluster *= 2
  rows, chunk_rows, chunks, stage_bytes = ring(cluster)
  stages = max(1, min(chunks, JVP_MAX_STAGES, budget // (2 * stage_bytes)))
  return dict(cluster=cluster, threads=JVP_THREADS, vec=vec, q=q,
              rows_in_flight=rows_in_flight, rows=rows,
              chunk_rows=chunk_rows, chunks=chunks, stages=stages,
              on_chip=stages == chunks, head_bytes=head,
              smem_bytes=head + 2 * stages * stage_bytes,
              blocks=cluster * B)


def groupnorm_act_jvp_plain(x: torch.Tensor, dx: Optional[torch.Tensor],
                            scale: torch.Tensor, bias: torch.Tensor,
                            dscale: Optional[torch.Tensor] = None,
                            dbias: Optional[torch.Tensor] = None,
                            num_groups: int = 32, act: str = 'silu',
                            eps: float = 1e-6) -> torch.Tensor:
  """The tangent of :func:`groupnorm_act_plain` at (x, scale, bias) along
  (dx, dscale, dbias), each tangent None for zero, by the formula of the
  module docstring in f32; output in ``x.dtype``."""
  B, H, W, C = x.shape
  shape = (B, H * W, num_groups, C // num_groups)
  g = x.float().reshape(shape)
  mean = g.mean(dim=(1, 3), keepdim=True)
  var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
  r = torch.rsqrt(var + eps)
  xh = (g - mean) * r
  dxh = torch.zeros_like(xh)
  if dx is not None:
    d = dx.float().reshape(shape)
    m1 = d.mean(dim=(1, 3), keepdim=True)
    m2 = (xh * d).mean(dim=(1, 3), keepdim=True)
    dxh = r * (d - m1 - xh * m2)
  xh, dxh = xh.reshape(x.shape), dxh.reshape(x.shape)
  z = xh * scale.float() + bias.float()
  dz = dxh * scale.float()
  if dscale is not None:
    dz = dz + xh * dscale.float()
  if dbias is not None:
    dz = dz + dbias.float()
  if act == 'silu':
    s = torch.sigmoid(z)
    dz = dz * s * (1 + z * (1 - s))
  elif act == 'elu':
    dz = dz * torch.where(z > 0, torch.ones_like(z), torch.exp(z))
  elif act != 'none':
    raise ValueError(f'unknown activation {act!r}')
  return dz.to(x.dtype)


def groupnorm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  num_groups: int = 32, act: str = 'silu',
                  eps: float = 1e-6) -> torch.Tensor:
  """x (B,H,W,C) -> act(GroupNorm(x)), same shape and dtype.

  Differentiable once in ``x``, ``scale`` and ``bias``, in reverse and in
  forward mode (see the module docstring).
  """
  if _build.differentiated(x, scale, bias):
    return _GroupNormAct.apply(x, scale, bias, num_groups, act, eps)
  return _groupnorm_act(x, scale, bias, num_groups, act, eps)


class _GroupNormAct(torch.autograd.Function):
  """K2 forward; backward by recomputing the plain version (JAX
  ``_groupnorm_act_bwd``); forward mode by :class:`_GroupNormActJvp` on
  the primals stripped of their tangents and detached (under
  ``torch.func.jvp`` the rule gets functorch's wrapped tensors, which only
  a Function's forward sees unwrapped)."""

  @staticmethod
  def forward(x, scale, bias, num_groups, act, eps):
    return _groupnorm_act(x, scale, bias, num_groups, act, eps)

  @staticmethod
  def setup_context(ctx, inputs, output):
    x, scale, bias, *args = inputs
    ctx.set_materialize_grads(False)    # a missing tangent comes as None
    ctx.save_for_backward(x, scale, bias)
    ctx.save_for_forward(x, scale, bias)
    ctx.args = tuple(args)

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, dy):
    inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
    with torch.enable_grad():
      y = groupnorm_act_plain(*inputs, *ctx.args)
    return torch.autograd.grad(y, inputs, dy) + (None, None, None)

  @staticmethod
  def jvp(ctx, dx, dscale, dbias, *_):
    # Detached: the tangent is not differentiated again.
    x, scale, bias = (fwAD.unpack_dual(t).primal.detach()
                      for t in ctx.saved_tensors)
    dx, dscale, dbias = (None if t is None else t.detach()
                         for t in (dx, dscale, dbias))
    return _GroupNormActJvp.apply(x, dx, scale, bias, dscale, dbias,
                                  *ctx.args)


class _GroupNormActJvp(torch.autograd.Function):
  """:func:`groupnorm_act_jvp` as a Function, so that under
  ``torch.func.jvp`` its launch sees unwrapped tensors.  Not
  differentiated itself."""

  @staticmethod
  def forward(x, dx, scale, bias, dscale, dbias, num_groups, act, eps):
    return groupnorm_act_jvp(x, dx, scale, bias, dscale, dbias, num_groups,
                             act, eps)

  @staticmethod
  def setup_context(ctx, inputs, output):
    pass

  @staticmethod
  def backward(ctx, ddy):
    raise NotImplementedError('the tangent of groupnorm_act is not '
                              'differentiated')


def _check(what, x, scale, bias, num_groups, act):
  """Raise on what the kernels do not take; returns (B, H, W, C)."""
  if x.device.type != 'cuda':
    raise ValueError(f'{what}: no kernel for device {x.device}')
  if x.ndim != 4:
    raise ValueError(f'{what}: x {tuple(x.shape)} is not NHWC')
  B, H, W, C = x.shape
  if num_groups <= 0 or C % num_groups:
    raise ValueError(f'{what}: {num_groups} groups do not divide {C}')
  if act not in ACTS:
    raise ValueError(f'unknown activation {act!r}')
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f'{what}: dtype {x.dtype} not supported')
  for t in (scale, bias):
    if t is not None and tuple(t.shape) != (C,):
      raise ValueError(f'{what}: scale and bias must be ({C},)')
    if t is not None and t.device != x.device:
      raise ValueError(f'{what}: x, scale and bias must share a device')
  if x.numel() >= 2 ** 31:
    raise ValueError(f'{what}: tensor too large for 32-bit indexing')
  return B, H, W, C


def _groupnorm_act(x, scale, bias, num_groups, act, eps):
  """The forward: the plain version for a CPU tensor, else the kernel."""
  if x.device.type == 'cpu':
    return groupnorm_act_plain(x, scale, bias, num_groups, act, eps)
  B, H, W, C = _check('groupnorm_act', x, scale, bias, num_groups, act)
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


def groupnorm_act_jvp(x: torch.Tensor, dx: Optional[torch.Tensor],
                      scale: torch.Tensor, bias: torch.Tensor,
                      dscale: Optional[torch.Tensor] = None,
                      dbias: Optional[torch.Tensor] = None,
                      num_groups: int = 32, act: str = 'silu',
                      eps: float = 1e-6) -> torch.Tensor:
  """The tangent of :func:`groupnorm_act` along (dx, dscale, dbias), each
  None for zero: :func:`groupnorm_act_jvp_plain` for a CPU tensor, else
  one launch of csrc/groupnorm_jvp.cu.  Output in ``x.dtype``."""
  if x.device.type == 'cpu':
    return groupnorm_act_jvp_plain(x, dx, scale, bias, dscale, dbias,
                                   num_groups, act, eps)
  B, H, W, C = _check('groupnorm_act_jvp', x, scale, bias, num_groups, act)
  _check('groupnorm_act_jvp', x, dscale, dbias, num_groups, act)
  if dx is not None and (dx.shape != x.shape or dx.device != x.device):
    raise ValueError('groupnorm_act_jvp: dx must be like x')
  plan = jvp_plan(H, W, C, num_groups, x.element_size(), B)
  if plan['smem_bytes'] > SMEM_LIMIT:
    raise ValueError(f'groupnorm_act_jvp: C = {C} needs '
                     f'{plan["smem_bytes"]} bytes of shared memory for its '
                     'statistics')
  x, dx, s, b, ds, db, dy, stream = _jvp_operands(x, dx, scale, bias, dscale,
                                                  dbias)
  lib = _build.load('groupnorm_jvp', _JVP_SIGNATURES)
  err = lib.groupnorm_act_jvp_nhwc(
      x.data_ptr(), dx.data_ptr(), s.data_ptr(), b.data_ptr(),
      None if ds is None else ds.data_ptr(),
      None if db is None else db.data_ptr(), dy.data_ptr(), B, H * W, C,
      num_groups, ACTS[act], eps, _DTYPE_CODES[x.dtype], plan['cluster'],
      plan['vec'], plan['rows'], plan['chunk_rows'], plan['stages'],
      plan['smem_bytes'], stream)
  _build.check_launch(err, 'groupnorm_act_jvp')
  groupnorm_act_jvp.launches += 1
  return dy


def _jvp_operands(x, dx, scale, bias, dscale, dbias):
  """x, dx (zeros for None) in x's dtype, contiguous and 16-byte aligned;
  scale, bias, dscale, dbias (None stays None) as f32; dy; the stream."""
  x, s, b, dy, stream = _operands(x, scale, bias)
  dx = torch.zeros_like(x) if dx is None else dx.to(x.dtype).contiguous()
  x, dx = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dx))
  ds, db = (None if t is None else t.float().contiguous()
            for t in (dscale, dbias))
  return x, dx, s, b, ds, db, dy, stream


def _groupnorm_act_jvp_cluster(x, dx, scale, bias, dscale=None, dbias=None,
                               num_groups=32, act='silu', eps=1e-6):
  """The first card design of the JVP (csrc/groupnorm_jvp_cluster.cu, K2's
  plan) on CUDA tensors: the yardstick ``chip_smoke.py`` times beside
  :func:`groupnorm_act_jvp`.  The main path never calls it."""
  B, H, W, C = _check('groupnorm_act_jvp', x, scale, bias, num_groups, act)
  plan = _cluster_jvp_plan(H, W, C, num_groups, x.element_size())
  x, dx, s, b, ds, db, dy, stream = _jvp_operands(x, dx, scale, bias, dscale,
                                                  dbias)
  lib = _build.load('groupnorm_jvp_cluster', _JVP_SIGNATURES)
  err = lib.groupnorm_act_jvp_nhwc(
      x.data_ptr(), dx.data_ptr(), s.data_ptr(), b.data_ptr(),
      None if ds is None else ds.data_ptr(),
      None if db is None else db.data_ptr(), dy.data_ptr(), B, H * W, C,
      num_groups, ACTS[act], eps, _DTYPE_CODES[x.dtype], plan['cluster'],
      plan['threads'], plan['vec'], plan['q'], int(plan['on_chip']),
      plan['smem_bytes'], stream)
  _build.check_launch(err, 'groupnorm_act_jvp (cluster)')
  return dy


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
groupnorm_act_jvp.launches = 0
