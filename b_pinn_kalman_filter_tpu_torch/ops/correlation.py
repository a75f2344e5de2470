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
does.  Under ``torch.func.vmap`` the mapped dimensions are folded into the
batch and the cost volume runs as ONE call (one kernel launch on the
card), as the JAX package's ``jax.vmap`` over B-PINN draws folds them into
one cost volume; the rule is the same on every device.
``correlation.launches`` counts the launches and ``correlation.batches``
the launches by batch size.  :func:`correlation_plan` sizes the kernel's
tiles and cluster.

Gradients.  With a cotangent d (B, H, W, 49) of the output, the input
gradients are ``df1 = B1(d, f2)`` and ``df2 = B2(d, f1)``::

    B1(d, g)[b, y, x, c] = (1/C) sum_k d[b, y, x, k] g[b, y+dy_k, x+dx_k, c]
    B2(d, h)[b, y, x, c] = (1/C) sum_k d[b, y-dy_k, x-dx_k, k]
                                       * h[b, y-dy_k, x-dx_k, c]

(:func:`correlation_df1`, :func:`correlation_df2`; on the card the two
entry points of ``csrc/correlation_bwd.cu``, on the CPU
:func:`correlation_df1_plain` and :func:`correlation_df2_plain`, explicit
formulas, not autograd of the forward).  The three maps are bilinear and
close under differentiation: against a cotangent G of ``B1(d, g)`` the
gradients are ``K3(G, g)`` for d and ``B2(d, G)`` for g; against H of
``B2(d, h)``, ``K3(h, H)`` for d and ``B1(d, H)`` for h.  So each is a
``torch.autograd.Function`` whose backward calls the other two, and
derivatives of any order stay on the kernels.  Each has the vmap rule
that folds the mapped dimensions into the batch.  ``correlation_df1`` and
``correlation_df2`` count their launches in ``.launches``.  Forward-mode
tangents take the plain version on the CPU and raise on the card
(ROADMAP.md B.3).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.ops import _build

_D = 3   # maximum displacement (7x7 window)
SHIFTS = (2 * _D + 1) ** 2
_SIGNATURES = {
    'correlation_f32': (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 11
                       + (ctypes.c_void_p,),
}
_BWD_SIGNATURES = {
    name: (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
    for name in ('correlation_df1_f32', 'correlation_df2_f32')
}
_TILE_SIGNATURES = {
    'correlation_tile_f32': (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
                            + (ctypes.c_void_p,),
}
# csrc/correlation.cu's sizes: at most 256 threads a block, clusters of at
# most 8 blocks, 16 channels a stage, the H100's 227 KB of shared memory a
# block.  The plan aims at half a wave of the card's 132 SMs.
MAX_THREADS = 256
MAX_SPLIT = 8
CHUNK = 16
SMEM_LIMIT = 232448
MAX_TILE_W = 32
MIN_BLOCKS = 64
MIN_THREADS = 112          # rows of a tile are not cut below this
MIN_RANK_CHANNELS = 8      # nor the channels of a cluster rank


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


def _shifts():
  """(k, dy, dx) of the 49 shifts, k = (dy + 3) * 7 + (dx + 3)."""
  side = range(-_D, _D + 1)
  return [(k, dy, dx) for k, (dy, dx) in enumerate(
      (dy, dx) for dy in side for dx in side)]


def correlation_df1_plain(d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch version of B1: d (B, H, W, 49), g (B, H, W, C) ->
  ``(1/C) sum_k d[..., k] * g shifted by +s_k`` (B, H, W, C)."""
  B, H, W, C = g.shape
  gp = F.pad(g, (0, 0, _D, _D, _D, _D))
  out = torch.zeros_like(g)
  for k, dy, dx in _shifts():
    out = out + d[..., k:k + 1] * gp[:, _D + dy:_D + dy + H,
                                     _D + dx:_D + dx + W, :]
  return out / C


def correlation_df2_plain(d: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
  """Plain PyTorch version of B2: d (B, H, W, 49), h (B, H, W, C) ->
  ``(1/C) sum_k (d[..., k] * h) shifted by -s_k`` (B, H, W, C)."""
  B, H, W, C = h.shape
  pad = (0, 0, _D, _D, _D, _D)
  dp, hp = F.pad(d, pad), F.pad(h, pad)
  out = torch.zeros_like(h)
  for k, dy, dx in _shifts():
    oy, ox = _D - dy, _D - dx
    out = out + (dp[:, oy:oy + H, ox:ox + W, k:k + 1]
                 * hp[:, oy:oy + H, ox:ox + W, :])
  return out / C


def _pad_col(x: int, strip: int) -> int:
  return x + x // strip if strip > 1 else x


@functools.lru_cache(maxsize=None)
def correlation_plan(B: int, H: int, W: int, C: int) -> Dict:
  """How csrc/correlation.cu covers a (B, H, W, C) cost volume.

  ``strip``: pixels along x a thread owns (4, 2 or 1: the widest that
  divides W, 4 from 16 columns up, 2 from 8).  ``tw`` x ``th``: a block's
  tile, dividing W and H exactly; ``tw`` the widest divisor of W up to 32
  that is a multiple of ``strip``, ``th`` the most rows within 256 threads
  (7 dy x th x tw / strip), cut while the grid has fewer than 64 blocks
  and the block keeps 112 threads.  ``split``: blocks of a cluster that
  share a tile, each taking ``cs`` channels (a multiple of 4, at least 8),
  doubled up to 8 while the grid has fewer than 64 blocks.  ``stages``: 2
  (double-buffered) where a block has more than one 16-channel chunk.
  ``vec``: 16-byte copies, where C is a multiple of 4.
  """
  strip = (4 if W % 4 == 0 and W >= 16 else
           2 if W % 2 == 0 and W >= 8 else 1)
  tw = max(d for d in range(strip, min(W, MAX_TILE_W) + 1, strip)
           if W % d == 0)
  per_row = (2 * _D + 1) * (tw // strip)
  rows = [d for d in range(H, 0, -1) if H % d == 0]
  th = next(d for d in rows if d * per_row <= MAX_THREADS)
  for d in rows:
    if d >= th:
      continue
    if B * (H // th) * (W // tw) >= MIN_BLOCKS or d * per_row < MIN_THREADS:
      break
    th = d
  tiles = (H // th) * (W // tw)
  split = 1
  while (B * tiles * split < MIN_BLOCKS and split < MAX_SPLIT
         and C % (8 * split) == 0
         and C // (2 * split) >= MIN_RANK_CHANNELS):
    split *= 2
  cs = C // split
  stages = 2 if cs > CHUNK else 1
  w1 = _pad_col(tw - 1, strip) + 1
  w2 = _pad_col(tw + 2 * _D - 1, strip) + 1
  stage_vecs = (CHUNK // 4) * (th * w1 + (th + 2 * _D) * w2)
  smem = stages * stage_vecs * 16 + th * tw * SHIFTS * 4
  return dict(strip=strip, tw=tw, th=th, split=split, cs=cs, stages=stages,
              vec=int(C % 4 == 0), threads=per_row * th, tiles=tiles,
              blocks=B * tiles * split, smem_bytes=smem)


def _check(f1: torch.Tensor, f2: torch.Tensor) -> None:
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
  if max(f1.numel(), B * H * W * SHIFTS) >= 2 ** 31:
    raise ValueError('correlation: tensor too large for 32-bit indexing')


def _cost_volume(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
  """Stride 1 on plain (unbatched) tensors: the kernel on a CUDA tensor,
  the plain version on a CPU one."""
  if f1.device.type == 'cpu':
    return correlation_plain(f1, f2)
  if f1.device.type != 'cuda':
    raise ValueError(f'correlation: no kernel for device {f1.device}')
  _check(f1, f2)
  B, H, W, C = f1.shape
  plan = correlation_plan(B, H, W, C)
  f1, f2 = _build.aligned(f1), _build.aligned(f2)
  out = torch.empty((B, H, W, SHIFTS), dtype=torch.float32, device=f1.device)
  lib = _build.load('correlation', _SIGNATURES)
  stream = torch.cuda.current_stream(f1.device).cuda_stream
  err = lib.correlation_f32(
      f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C, plan['th'],
      plan['tw'], plan['strip'], plan['split'], plan['cs'], plan['stages'],
      plan['vec'], stream)
  _build.check_launch(err, 'correlation')
  correlation.launches += 1
  correlation.batches[B] += 1
  return out


def _gradient(which: str, d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """B1 (``which`` 'df1') or B2 ('df2') of d (B, H, W, 49) and g (B, H, W,
  C): the kernel on a CUDA tensor, the plain version on a CPU one."""
  if g.device.type == 'cpu':
    return _PLAIN[which](d, g)
  if g.device.type != 'cuda':
    raise ValueError(f'correlation {which}: no kernel for device {g.device}')
  _check(g, g)
  if d.shape != g.shape[:3] + (SHIFTS,) or d.dtype != torch.float32:
    raise ValueError(f'correlation {which}: d {tuple(d.shape)} {d.dtype} is '
                     f'not float32 {tuple(g.shape[:3]) + (SHIFTS,)}')
  if d.device != g.device:
    raise ValueError(f'correlation {which}: d and g must share a device')
  B, H, W, C = g.shape
  d, g = _build.aligned(d), _build.aligned(g)
  out = torch.empty_like(g)
  lib = _build.load('correlation_bwd', _BWD_SIGNATURES)
  stream = torch.cuda.current_stream(g.device).cuda_stream
  err = getattr(lib, f'correlation_{which}_f32')(
      d.data_ptr(), g.data_ptr(), out.data_ptr(), B, H, W, C, stream)
  _build.check_launch(err, f'correlation {which}')
  _PUBLIC[which].launches += 1
  return out


def _fold_vmap(fn, info, in_dims, *args):
  """A vmap rule: the mapped dimension (broadcast where unmapped) folded
  into the batch, so that a vmapped call is one call of ``fn``."""
  n = info.batch_size
  args = [t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
          for t, d in zip(args, in_dims)]
  out = fn.apply(*(t.reshape(-1, *t.shape[2:]) for t in args))
  return out.reshape(n, -1, *out.shape[1:]), 0


class _CostVolume(torch.autograd.Function):
  """K3(f1, f2) at stride 1; gradients B1(dout, f2) and B2(dout, f1)."""

  @staticmethod
  def forward(f1, f2):
    return _cost_volume(f1, f2)

  @staticmethod
  def setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)

  @staticmethod
  def backward(ctx, grad):
    f1, f2 = ctx.saved_tensors
    return (_Df1.apply(grad, f2) if ctx.needs_input_grad[0] else None,
            _Df2.apply(grad, f1) if ctx.needs_input_grad[1] else None)

  @staticmethod
  def vmap(info, in_dims, f1, f2):
    return _fold_vmap(_CostVolume, info, in_dims, f1, f2)


class _Df1(torch.autograd.Function):
  """B1(d, g); gradients K3(G, g) for d and B2(d, G) for g."""

  @staticmethod
  def forward(d, g):
    return _gradient('df1', d, g)

  @staticmethod
  def setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)

  @staticmethod
  def backward(ctx, grad):
    d, g = ctx.saved_tensors
    return (_CostVolume.apply(grad, g) if ctx.needs_input_grad[0] else None,
            _Df2.apply(d, grad) if ctx.needs_input_grad[1] else None)

  @staticmethod
  def vmap(info, in_dims, d, g):
    return _fold_vmap(_Df1, info, in_dims, d, g)


class _Df2(torch.autograd.Function):
  """B2(d, h); gradients K3(h, H) for d and B1(d, H) for h."""

  @staticmethod
  def forward(d, h):
    return _gradient('df2', d, h)

  @staticmethod
  def setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)

  @staticmethod
  def backward(ctx, grad):
    d, h = ctx.saved_tensors
    return (_CostVolume.apply(h, grad) if ctx.needs_input_grad[0] else None,
            _Df1.apply(d, grad) if ctx.needs_input_grad[1] else None)

  @staticmethod
  def vmap(info, in_dims, d, h):
    return _fold_vmap(_Df2, info, in_dims, d, h)


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
  """Cost volume of f1 against f2, (B, H, W, C) float32 each."""
  if stride != 1 or _build.tangents('correlation', f1, f2):
    return correlation_plain(f1, f2, stride)
  return _CostVolume.apply(f1, f2)


def correlation_df1(d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """B1(d, g): the gradient of the cost volume for f1, with g = f2."""
  if _build.tangents('correlation_df1', d, g):
    return correlation_df1_plain(d, g)
  return _Df1.apply(d, g)


def correlation_df2(d: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
  """B2(d, h): the gradient of the cost volume for f2, with h = f1."""
  if _build.tangents('correlation_df2', d, h):
    return correlation_df2_plain(d, h)
  return _Df2.apply(d, h)


def _correlation_tile(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
  """The first card design (csrc/correlation_tile.cu, one block per image
  and 8x8 tile) on CUDA tensors: the yardstick ``chip_smoke.py`` times
  beside :func:`correlation`.  The main path never calls it."""
  _check(f1, f2)
  B, H, W, C = f1.shape
  f1, f2 = f1.contiguous(), f2.contiguous()
  out = torch.empty((B, H, W, SHIFTS), dtype=torch.float32, device=f1.device)
  lib = _build.load('correlation_tile', _TILE_SIGNATURES)
  stream = torch.cuda.current_stream(f1.device).cuda_stream
  err = lib.correlation_tile_f32(f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                                 B, H, W, C, stream)
  _build.check_launch(err, 'correlation (tile)')
  return out


correlation.launches = 0
correlation.batches = collections.Counter()
correlation_df1.launches = 0
correlation_df2.launches = 0
_PLAIN = {'df1': correlation_df1_plain, 'df2': correlation_df2_plain}
_PUBLIC = {'df1': correlation_df1, 'df2': correlation_df2}
