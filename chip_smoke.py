#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--steps N] [--requests R] [--cycles C]
                          [--train-steps T] [--prelim-steps P]
                          [--pinn-steps Q] [--seed S] [--out DIR]

Run from the root of a checkout; it needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and imports nothing of JAX or the JAX package.  Phases:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build the CUDA kernels from ``b_pinn_kalman_filter_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once), print the build time, each
   kernel's ``-Xptxas -v`` lines and, where ``cuobjdump`` exists, the
   ``HGMMA`` (tensor-core) instructions in the wgmma conv's SASS;
3. find the K1/K2 sites' shapes from one full-width forward of the flagship
   U-Net (``vp/cifar10_ddpmpp_continuous``: nf 128, ch_mult (1,2,2,2), 4
   res blocks, 32x32, batch 8), then hold each kernel against its plain
   version on the card at every distinct shape, in f32 (TF32 off for convs
   and matmuls) and in bf16, and time kernel, plain version and the one
   PyTorch library call of the same function (cuDNN ``F.conv2d``;
   ``F.group_norm`` + ``F.silu``): their device time from
   ``torch.profiler``, and the kernel's time per call back to back with
   CUDA events (the host's time where it exceeds the kernel's).  In bf16
   the first port's kernels are timed beside the main path's (K1's
   direct kernel, K2's one block per group), through private entries the
   main path never calls; K1 is also summed per level of the U-Net;
4. hold K3 (cost volume) and K4 (NS step) against their plain versions in
   f32 at every shape the ``ukf`` path launches them with (the five FlowNet
   levels of ``pinn/pinn_pde`` with the 8 B-PINN draws folded into the
   batch; the 129 sigma points and the rollout's one image at 64x64) and at
   an odd shape, K3 also at batch 1, and time both as in phase 3, each
   beside its first card design, the yardstick (K3: one block per image and
   8x8 tile, csrc/correlation_tile.cu, also at batch 1 as the draws were
   launched one by one; K4: three staged launches, csrc/ns_step_staged.cu);
   K3 runs twice and must give the same bits (no single PyTorch call
   computes either function);
5. a full-width flagship forward with every parameter randomised: the
   kernel path against the plain path, in f32 and bf16, each timed on the
   host's clock and in device time;
6. serve ``--requests`` sample requests through ``run_lib.sample`` (batch 8,
   N = ``--steps``, default the config's 1000, bf16) with the launch counts
   set to 0 before and read after; the counts must be the per-forward site
   counts times N times the requests, every K1 launch the wgmma kernel's,
   and the samples finite; then profile one steady sampler step
   (``torch.profiler``): host and device-busy seconds, idle share, top
   device ops;
7. the training step (``--train-steps``, default 40): one step's loss and
   gradients at the flagship's full width and batch 128, kernel path
   against plain path (the same randomised parameters, batch, t, z and
   dropout generator), in f32 (TF32 off) and bf16, each leaf's gradient
   within the limit; K1 as the data gradient (dy through the flipped
   kernel) at every site shape at batch 128, against its plain version
   in f32 and bf16 and timed in bf16 beside ``torch.nn.grad.conv2d_input``;
   then ``run_lib.train`` at batch 128 in bf16 for steps 0..40 with the
   cadence cut so that log, eval, the preemption checkpoint and a snapshot
   (sampling at N = ``--steps``) fire, the launch counts set to 0 before
   and read after (K1: per step every forward site and every data-gradient
   site, each the wgmma kernel; K2: every forward site; plus the eval and
   sampling forwards); checks: finite losses, parameters moved, the EMA
   step on one leaf, the snapshot samples; steady steps/s and imgs/s
   (event-free steps, each synchronised), peak memory, one steady step
   under ``torch.profiler``; then a second call that resumes from the
   preemption checkpoint;
8. run the ``ukf`` entry point ``ukf_lib.run`` at the full width of
   ``pinn/pinn_pde`` (64x64, FlowNet levels 16..128, 8x8 patches: 256
   filters of dimension 64, 8 B-PINN draws a cycle) for ``--cycles``
   cycles (default 10) with seeded random B-PINN parameters, the launch
   counts set to 0 before and read after; the counts must be those of the
   design (K3: one launch per level a cycle, each at batch 8, the draws
   vmapped; K4: one call a cycle with the 129 sigma points, plus the 63
   steps of the 64-frame rollout, each the one-launch kernel), the final
   belief finite with a nonnegative sqrt-covariance diagonal, and the
   filtered f-MSE below that of the noisy observation; then one steady
   cycle's measurement two ways, with the draws vmapped (the port's) and
   one ``functional_call`` after another (the structure before, kept here
   as the yardstick), on the same draws: their outputs compared, their
   host seconds, and each under ``torch.profiler`` (host and device-busy
   seconds, idle share, device ops, top ops), and the filter profiled
   likewise;
9. PINN phase 1 (``pinn/pinn_pde`` at full width: batch 64, 64x64,
   FlowNet levels 16..128, f32, TF32 off): K3's backward (B1 and B2,
   csrc/correlation_bwd.cu) against its plain versions at the five level
   shapes at batch 64 and an odd shape, each run twice for its bits, and
   one second-order product against autograd of the plain cost volume,
   all timed as in phase 3; one prelim step's loss and gradients, kernel
   path against plain path (the same randomised parameters, batch, mask
   and noise), every leaf within the limit of the largest leaf's
   gradient; then ``pinn_lib.train_prelim`` on the synthetic PDE data
   (rolled out by K4 at 200x128 into an empty data directory) for steps
   0..``--prelim-steps`` (default 40) with the cadence cut so that log,
   eval, the preemption checkpoint and a snapshot fire, the launch counts
   set to 0 before and read after (K3: per train step 5 forward, 5 B1 and
   5 B2 launches, per eval 5 forward; K4: one per rollout frame); steady
   step seconds and samples/s, the batch's assembly on the host, peak
   memory, one steady step under ``torch.profiler``, then a resume from
   the preemption checkpoint;
10. PINN phase 2 (the same width): a third-order product through K3, B1
   and B2 (the gradient of a seeded linear functional of phase 9's
   second-order product) against autograd of the plain cost volume at the
   five level shapes at batch 64 and an odd shape, within 1e-5; one
   phase-2 loss, kernel path against plain path (the same randomised
   parameters, batch, mask and noise): the residual and the data loss,
   the gradient of the NS residual alone (leaves it does not reach as
   zeros) and the total gradient, every leaf within the limit of the
   largest leaf's gradient, with the kernel path's K3, B1 and B2 launches
   by stage of the residual (forward, first and second derivatives,
   parameter gradient), by level, for a train step and an eval step; then
   ``pinn_lib.train``: phase 1 for steps 0..2, phase 2 for steps
   2..2 + ``--pinn-steps`` (default 20) with the cadence cut so that log,
   eval, the ``checkpoint_pinn`` preemption checkpoint and a snapshot fire
   in phase 2, the launch counts set to 0 before and read after (against
   the step's and the eval's counts); checks: finite losses, every leaf
   moved in phase 2, phase 2's Adam counts fresh, the step numbers; the
   steady phase-2 step's seconds and samples/s, peak memory, one steady
   step under ``torch.profiler`` (K3's and its backward's device ms), then
   a resume (phase 1 after its last preemption checkpoint, phase 2 from
   ``checkpoint_pinn``);
11. print the kernel table as one JSON line (every kernel of the paths and
   every yardstick beside it; K3's and K3 backward's rows also carry their
   phase-2 launches and device ms), then the ``{"ok": true, ...}`` line.
   With ``--out DIR`` the per-shape details go to ``DIR/chip_smoke.json``.

Error limits (relative to max |reference|), in phases 3 to 5, 7, 9 and 10:
f32 1e-4 (K3 at third order 1e-5); bf16 3e-2, the bound
tests/test_winograd.py holds bf16 Winograd to.

Any failed phase exits non-zero without the last line.  Without a CUDA card
it exits 2 and prints no result.
"""

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.func import functional_call
from torch.profiler import ProfilerActivity, profile

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.core import losses, sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data.datasets import get_dataset
from b_pinn_kalman_filter_tpu_torch.data.ns_rollout import ns_rollout
from b_pinn_kalman_filter_tpu_torch.kalman import ukf_lib
from b_pinn_kalman_filter_tpu_torch.models import layers, registry
from b_pinn_kalman_filter_tpu_torch.ops import _build
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from b_pinn_kalman_filter_tpu_torch.ops import ns_step as k4
from b_pinn_kalman_filter_tpu_torch.pinn import bayes, pinn_lib
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import (
    PINN, equation_mse_from_outputs)
from b_pinn_kalman_filter_tpu_torch.pinn.pinn_lib import init_pinn
from b_pinn_kalman_filter_tpu_torch.train import run_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib

CONFIG = 'vp/cifar10_ddpmpp_continuous'
BATCH = 8
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Published H100 SXM peaks (NVIDIA H100 datasheet): HBM 3.35 TB/s;
# bf16 tensor cores 989 TFLOP/s; f32 on the CUDA cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
UKF_CONFIG = 'pinn/pinn_pde'
NS_DT, NS_DX = 0.0025, 1 / 200
# Device ops grouped by name in the profiles: the port's kernels, the
# libraries' convolutions, matrix products, QRs and triangular solves
# (cuDNN, cuBLAS, MAGMA), and PyTorch's own kernels by kind.  The first
# family whose key matches takes an op.
DEVICE_FAMILIES = (
    ('K1 conv3x3', ('conv3x3_wgmma_kernel', 'conv3x3_nhwc_kernel')),
    ('K2 groupnorm_act', ('groupnorm_act_kernel',)),
    ('K3 correlation backward', ('correlation_bwd_kernel',)),
    ('K3 correlation', ('correlation_kernel',)),
    ('K4 ns_step', ('ns_step_kernel', 'velocity_kernel',
                    'pressure_density_kernel')),
    ('library (cuDNN, cuBLAS, MAGMA)', ('xmma', 'gemm', 'cutlass', 'cudnn',
                                        'sm90_', 'sm80_', 'wgrad', 'dgrad',
                                        'geqr', 'trsm')),
    ('reduce', ('reduce_kernel',)),
    ('copy/cast', ('copy', 'Copy')),
    ('elementwise', ('elementwise',)),
)
# A gradient leaf whose largest element is below this share of the largest
# leaf's in f32 is zero but for rounding (the attention blocks' key
# biases: ~1e-9 of it on a small U-Net, every other leaf above 1e-3).
ZERO_LEAF = 1e-6
# f32 operations per pixel of one NS step, counted from csrc/ns_step.cu
# (stage 1: 10, stage 2: 2 x 96, stage 3: 19 + 96; a division as one).
NS_STEP_OPS = 317


def log(*args):
  print(*args, flush=True)


def time_ms(fn, iters=20, warmup=3):
  """Mean ms of ``fn()`` over ``iters`` back-to-back calls (CUDA events).
  Where the host takes longer to issue a call than the device to run it,
  this is the host's time per call."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
  """Mean device ms of ``fn()``: the summed own times of the device ops
  (kernels, copies) that ``iters`` calls launch, from ``torch.profiler``,
  over ``iters``.  The host's time between launches is not in it."""
  for _ in range(warmup):
    fn()
  # A trace now and then comes back without its device events; take
  # another (and fail, not report 0, if none has them).
  for _ in range(5):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _ in range(iters):
        fn()
      torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if busy_us > 0:
      return busy_us * 1e-3 / iters
  raise RuntimeError('torch.profiler recorded no device time in 5 traces')


def timings(kernel, plain, library=None, prev=None):
  """Device ms of the kernel, its plain version, the library call and the
  first port's kernel (taken in turns: kernel, first port, kernel), and
  ``call_ms``, the kernel's time per call back to back (CUDA events)."""
  row = dict(ms=device_ms(kernel), call_ms=time_ms(kernel),
             plain_ms=device_ms(plain),
             library_ms=None if library is None else device_ms(library))
  if prev is not None:
    row['prev_ms'] = device_ms(prev)
    row['ms'] = (row['ms'] + device_ms(kernel)) / 2
  return row


def bound(flops, nbytes, dtype):
  """Least time in ms and what sets it: bytes over the memory rate or
  operations over the peak rate of ``dtype``."""
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[dtype] * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def hgmma_count():
  """``HGMMA`` instructions in the built wgmma conv's SASS, or None where
  the toolkit has no ``cuobjdump``."""
  tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
  if not os.path.exists(tool):
    return None
  sass = subprocess.run([tool, '-sass', _build.library_path('conv3x3_wgmma')],
                        capture_output=True, text=True, check=True,
                        timeout=120).stdout
  return sum('HGMMA' in line for line in sass.splitlines())


def rel_err(got, want):
  err = float((got.float() - want.float()).abs().max())
  return err, err / max(float(want.float().abs().max()), 1e-30)


@torch.no_grad()
def randomize_(model, seed):
  """Every parameter redrawn: kernels ~ N(0, 1/fan_in), GroupNorm scales ~
  1 + N(0, 0.1), biases ~ N(0, 0.1).  (The init_scale=0 convs would make a
  fresh net output ~0 and hide a wrong kernel.)"""
  g = torch.Generator().manual_seed(seed)
  for name, p in model.named_parameters():
    v = torch.randn(p.shape, generator=g)
    if p.ndim >= 2:
      v /= p[..., 0].numel() ** 0.5
    elif name.endswith('scale'):
      v = 1.0 + 0.1 * v
    else:
      v = 0.1 * v
    p.copy_(v)


def flagship(dtype, kernels, seed):
  config = configs.get_config(CONFIG)
  config.tpu.compute_dtype = {torch.float32: 'float32',
                              torch.bfloat16: 'bfloat16'}[dtype]
  model = registry.create_model(config, device='cuda', seed=seed,
                                kernels=kernels)
  randomize_(model, seed)
  return config, model


def model_inputs(config, seed):
  g = torch.Generator(device='cuda').manual_seed(seed)
  size, ch = config.data.image_size, config.data.num_channels
  x = torch.randn((BATCH, size, size, ch), generator=g, device='cuda')
  labels = torch.rand((BATCH,), generator=g, device='cuda') * 999
  return x, labels


def site_shapes(model, config, seed):
  """Kernel-site shapes of one forward, with their counts per forward."""
  convs, norms = collections.Counter(), collections.Counter()

  def conv_hook(mod, args):
    kernel = mod.Conv_0.kernel
    if mod.kernels and k1.applicable(args[0].shape, kernel.shape):
      _, H, W, cin = args[0].shape
      convs[(H, W, cin, kernel.shape[3])] += 1

  def norm_hook(mod, args):
    if mod.kernels and mod.act in layers.FUSABLE_ACTS:
      _, H, W, C = args[0].shape
      norms[(H, W, C, mod.num_groups)] += 1

  handles = []
  for m in model.modules():
    if isinstance(m, layers.Conv3x3):
      handles.append(m.register_forward_pre_hook(conv_hook))
    elif isinstance(m, layers.GroupNorm):
      handles.append(m.register_forward_pre_hook(norm_hook))
  try:
    with torch.inference_mode():
      model(*model_inputs(config, seed), train=False)
  finally:
    for h in handles:
      h.remove()
  return convs, norms


def check_conv(shape, dtype, seed):
  H, W, cin, cout = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  x = torch.randn((BATCH, H, W, cin), generator=g, device='cuda').to(dtype)
  # Weights already in the working dtype, so that the wrapper's cast is a
  # no-op and the device time is the kernel's alone.
  w = (torch.randn((3, 3, cin, cout), generator=g, device='cuda') / (
      9 * cin) ** 0.5).to(dtype)
  b = 0.1 * torch.randn((cout,), generator=g, device='cuda')
  with torch.inference_mode():
    got = k1.conv3x3(x, w, b)
    want = k1.conv3x3_plain(x, w, b)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    # The library call on the same function: cuDNN on the NHWC data
    # (channels-last NCHW view) in the working dtype.
    x_lib = x.permute(0, 3, 1, 2)
    w_lib = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b_lib = b.to(dtype)
    which = k1.kernel_for(dtype, cin, cout)
    # The first port's direct kernel on the same inputs, where the main
    # path now takes the wgmma kernel.
    prev = None if which == 'direct' else (
        lambda: k1._conv3x3_direct(x, w, b))
    row = dict(kernel=which, **timings(
        lambda: k1.conv3x3(x, w, b), lambda: k1.conv3x3_plain(x, w, b),
        lambda: F.conv2d(x_lib, w_lib, b_lib, padding=1), prev))
    if prev is not None:
      row['prev_abs_err'], row['prev_rel_err'] = rel_err(prev(), want)
  itemsize = x.element_size()
  flops = 2 * 9 * BATCH * H * W * cin * cout
  nbytes = (x.numel() + w.numel() + BATCH * H * W * cout) * itemsize + 4 * cout
  row['bound_ms'], row['bound_by'] = bound(flops, nbytes, dtype)
  row.update(max_abs_err=abs_err, rel_err=rel)
  return row


def check_norm(shape, dtype, seed):
  H, W, C, G = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  x = (torch.randn((BATCH, H, W, C), generator=g, device='cuda') * 2 + 0.5
       ).to(dtype)
  scale = 1 + 0.1 * torch.randn((C,), generator=g, device='cuda')
  bias = 0.1 * torch.randn((C,), generator=g, device='cuda')
  with torch.inference_mode():
    got = k2.groupnorm_act(x, scale, bias, G, 'silu')
    want = k2.groupnorm_act_plain(x, scale, bias, G, 'silu')
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    x_lib = x.permute(0, 3, 1, 2)
    s_lib, b_lib = scale.to(dtype), bias.to(dtype)
    # The first port's kernel (one block per image and group).
    prev = lambda: k2._groupnorm_act_pergroup(x, scale, bias, G, 'silu')
    row = timings(
        lambda: k2.groupnorm_act(x, scale, bias, G, 'silu'),
        lambda: k2.groupnorm_act_plain(x, scale, bias, G, 'silu'),
        lambda: F.silu(F.group_norm(x_lib, G, s_lib, b_lib, 1e-6)), prev)
    row['prev_abs_err'], row['prev_rel_err'] = rel_err(prev(), want)
  n = x.numel()
  nbytes = 2 * n * x.element_size() + 8 * C
  row['bound_ms'], row['bound_by'] = bound(10 * n, nbytes, dtype)
  row.update(max_abs_err=abs_err, rel_err=rel)
  return row


def kernel_phase(name, sites, check, seed):
  """Every site shape in f32 and bf16; returns (rows, per-forward totals in
  bf16, the main path's dtype)."""
  rows, failures = [], []
  for i, (shape, count) in enumerate(sorted(sites.items())):
    for dtype in (torch.float32, torch.bfloat16):
      row = check(shape, dtype, seed + i)
      row.update(shape=list(shape), dtype=str(dtype).split('.')[-1],
                 per_forward=count, tol=TOL[dtype])
      rows.append(row)
      prev = (f' first port {row["prev_ms"]:.4f} (rel '
              f'{row["prev_rel_err"]:.1e})' if 'prev_ms' in row else '')
      log(f'  {name} {shape} {row["dtype"]:8s} x{count:<2d} '
          f'{row.get("kernel", "")} abs {row["max_abs_err"]:.3e} rel '
          f'{row["rel_err"]:.3e} | kernel {row["ms"]:.4f} ms (call '
          f'{row["call_ms"]:.4f}){prev} plain '
          f'{row["plain_ms"]:.4f} library {row["library_ms"]:.4f} bound '
          f'{row["bound_ms"]:.4f} ({row["bound_by"]})')
      for key in ('rel_err', 'prev_rel_err'):
        if key in row and not row[key] <= TOL[dtype]:
          failures.append(f'{name} {shape} {row["dtype"]}: {key} '
                          f'{row[key]:.3e} > {TOL[dtype]}')
  bf16 = [r for r in rows if r['dtype'] == 'bfloat16']
  total = {k: sum(r[k] * r['per_forward'] for r in bf16)
           for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
  prev_total = sum(r['prev_ms'] * r['per_forward'] for r in bf16)
  call_total = sum(r['call_ms'] * r['per_forward'] for r in bf16)
  log(f'  {name} per forward (bf16, device ms): kernel {total["ms"]:.4f}, '
      f'first port {prev_total:.4f}, plain {total["plain_ms"]:.4f}, library '
      f'{total["library_ms"]:.4f}, bound {total["bound_ms"]:.4f}; kernel '
      f'calls back to back {call_total:.4f}')
  levels = {}
  for r in bf16:
    level = levels.setdefault(r['shape'][0], dict(
        sites=0, ms=0.0, prev_ms=0.0, library_ms=0.0, bound_ms=0.0))
    level['sites'] += r['per_forward']
    for k in ('ms', 'prev_ms', 'library_ms', 'bound_ms'):
      level[k] += r[k] * r['per_forward']
  for h, level in sorted(levels.items(), reverse=True):
    log(f'    {h}x{h}: {level["sites"]} sites, kernel {level["ms"]:.4f} ms, '
        f'first port {level["prev_ms"]:.4f}, library '
        f'{level["library_ms"]:.4f}, bound {level["bound_ms"]:.4f}')
  by = collections.Counter()
  for r in bf16:
    by[r['bound_by']] += r['bound_ms'] * r['per_forward']
  total['bound_by'] = by.most_common(1)[0][0]
  total['max_abs_err'] = max(r['max_abs_err'] for r in bf16)
  prev_err = max(r.get('prev_abs_err', 0.0) for r in bf16)
  return rows, total, dict(prev_ms=prev_total, prev_abs_err=prev_err,
                           call_ms=call_total, levels=levels), failures


def check_corr(shape, seed):
  """K3 against its plain version at (B, H, W, C), f32, beside the tile
  kernel (its first card design) in turns; K3 run twice for its bits."""
  B, H, W, C = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  f1 = torch.randn(shape, generator=g, device='cuda')
  f2 = torch.randn(shape, generator=g, device='cuda')
  with torch.inference_mode():
    got = k3.correlation(f1, f2)
    again = k3.correlation(f1, f2)
    tile = k3._correlation_tile(f1, f2)
    want = k3.correlation_plain(f1, f2)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    row = timings(lambda: k3.correlation(f1, f2),
                  lambda: k3.correlation_plain(f1, f2),
                  prev=lambda: k3._correlation_tile(f1, f2))
  row['prev_abs_err'], row['prev_rel_err'] = rel_err(tile, want)
  row['same_bits_twice'] = bool(torch.equal(got, again))
  row['plan'] = k3.correlation_plan(*shape)
  pixels = B * H * W
  row['bound_ms'], row['bound_by'] = bound(
      2 * 49 * C * pixels, 2 * pixels * C * 4 + 49 * pixels * 4,
      torch.float32)
  row.update(max_abs_err=abs_err, rel_err=rel)
  return row


def ns_fields(shape, seed):
  B, H, W = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  d = torch.rand(shape, generator=g, device='cuda')
  u = 0.2 * torch.randn(shape, generator=g, device='cuda')
  v = 0.2 * torch.randn(shape, generator=g, device='cuda')
  p = 0.05 * torch.randn(shape, generator=g, device='cuda')
  u[:, :H // 2, :W // 2] = 0      # a region at rest: sign(0) = +1
  v[:, :H // 2, :W // 2] = 0
  return d, u, v, p


def check_ns(shape, seed):
  """K4 against its plain version at (B, H, W), f32, beside the staged
  kernel (its first card design) in turns; the error is the largest over
  the four fields."""
  B, H, W = shape
  args = ns_fields(shape, seed) + (NS_DT, NS_DX)
  with torch.inference_mode():
    got = k4.ns_step_fused(*args)
    staged = k4._ns_step_staged(*args)
    want = k4.ns_step(*args)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    prev_errs = [rel_err(a, b) for a, b in zip(staged, want)]
    row = timings(lambda: k4.ns_step_fused(*args), lambda: k4.ns_step(*args),
                  prev=lambda: k4._ns_step_staged(*args))
  row['plan'] = k4.ns_step_plan(B, H, W)
  pixels = B * H * W
  row['bound_ms'], row['bound_by'] = bound(NS_STEP_OPS * pixels,
                                           8 * pixels * 4, torch.float32)
  row.update(max_abs_err=max(e[0] for e in errs),
             rel_err=max(e[1] for e in errs),
             prev_abs_err=max(e[0] for e in prev_errs),
             prev_rel_err=max(e[1] for e in prev_errs))
  return row


def flow_kernel_phase(seed):
  """K3 and K4 at the ukf path's shapes and an odd one, f32, each beside
  its yardstick.  Returns (rows, per-cycle totals, failures): a cycle runs
  K3 once per FlowNet level at batch 8 (the draws folded in) and K4 once
  on the 129 sigma points.  The yardstick's totals are taken at the same
  shapes (``prev_ms``) and, for K3, also as the draws were launched before
  they were vmapped, 8 launches per level at batch 1 (``prev_ms_b1``)."""
  config = configs.get_config(UKF_CONFIG)
  size = config.data.image_size
  n = config.kf.patch_size ** 2
  draws = ukf_lib.N_DRAWS
  levels = [(size >> (i + 1), c)
            for i, c in enumerate(config.model.feature_nums)]
  corr_shapes = ([((draws, h, h, c), 1) for h, c in levels]
                 + [((1, h, h, c), 0) for h, c in levels]
                 + [((3, 13, 7, 3), 0)])
  ns_shapes = [((2 * n + 1, size, size), 1), ((1, size, size), 0),
               ((3, 13, 7), 0)]
  rows, failures, totals = [], [], {}
  for name, check, shapes in (('correlation', check_corr, corr_shapes),
                              ('ns_step_fused', check_ns, ns_shapes)):
    mine = []
    for i, (shape, per_cycle) in enumerate(shapes):
      row = check(shape, seed + i)
      row.update(kernel=name, shape=list(shape), dtype='float32',
                 per_cycle=per_cycle, tol=TOL[torch.float32])
      mine.append(row)
      share = row['bound_ms'] / row['ms']
      log(f'  {name} {shape} x{per_cycle} abs {row["max_abs_err"]:.3e} '
          f'rel {row["rel_err"]:.3e} | kernel {row["ms"]:.4f} ms (call '
          f'{row["call_ms"]:.4f}) yardstick {row["prev_ms"]:.4f} (rel '
          f'{row["prev_rel_err"]:.1e}) plain {row["plain_ms"]:.4f} bound '
          f'{row["bound_ms"]:.6f} ({row["bound_by"]}; '
          + (f'{share:.3f} of the kernel time' if share <= 1 else
             'kernel under the HBM bound: inputs from L2') + ')'
          + (f' plan {row["plan"]}' if 'plan' in row else '')
          + ('' if row.get('same_bits_twice', True) else ' NOT BITWISE'))
      for key in ('rel_err', 'prev_rel_err'):
        if not row[key] <= TOL[torch.float32]:
          failures.append(f'{name} {shape}: {key} {row[key]:.3e}')
      if not row.get('same_bits_twice', True):
        failures.append(f'{name} {shape}: two runs differ')
    total = {k: sum(r[k] * r['per_cycle'] for r in mine)
             for k in ('ms', 'plain_ms', 'bound_ms', 'prev_ms')}
    by = collections.Counter()
    for r in mine:
      by[r['bound_by']] += r['bound_ms'] * r['per_cycle']
    total.update(bound_by=by.most_common(1)[0][0], library_ms=None,
                 max_abs_err=max(r['max_abs_err'] for r in mine),
                 prev_abs_err=max(r['prev_abs_err'] for r in mine))
    if name == 'correlation':
      total['prev_ms_b1'] = draws * sum(r['prev_ms'] for r in mine
                                        if r['shape'][0] == 1)
    totals[name] = total
    rows += mine
  c, k = totals['correlation'], totals['ns_step_fused']
  log(f'  per cycle (device ms): K3 {c["ms"]:.4f} in {len(levels)} launches '
      f'at batch {draws} vs tile kernel {c["prev_ms"]:.4f} at the same '
      f'shapes and {c["prev_ms_b1"]:.4f} in {len(levels) * draws} launches '
      f'at batch 1; bound {c["bound_ms"]:.6f}.  K4 {k["ms"]:.4f} vs staged '
      f'{k["prev_ms"]:.4f}; bound {k["bound_ms"]:.6f}')
  return rows, totals, failures


def ukf_phase(cycles, out_dir):
  """The ukf entry point at full pinn_pde width; returns (report,
  launches, expected launches, failures)."""
  config = configs.get_config(UKF_CONFIG)
  levels = len(config.model.feature_nums)
  frames = max(cycles + 2, 64)
  expected = {'correlation': levels * cycles,
              'ns_step_fused': cycles + frames - 1}
  failures = []
  seconds = []
  with tempfile.TemporaryDirectory() as tmp:
    workdir = os.path.join(out_dir, 'ukf') if out_dir else tmp
    reset_counts()
    torch.cuda.synchronize()
    start = time.time()
    mse = ukf_lib.run(config, workdir, n_steps=cycles, device='cuda',
                      cycle_seconds=seconds)
    torch.cuda.synchronize()
    total_s = time.time() - start
    launches = {'correlation': k3.correlation.launches,
                'ns_step_fused': k4.ns_step_fused.launches,
                'conv3x3': k1.conv3x3.launches,
                'groupnorm_act': k2.groupnorm_act.launches}
    corr_batches = dict(k3.correlation.batches)
    ns_by_kernel = dict(k4.ns_step_fused.launches_by_kernel)
    preds, gts, obsvs = (np.load(os.path.join(workdir, f'ukf_{k}.npy'))
                         for k in ('preds', 'gts', 'obsvs'))
    belief = np.load(os.path.join(workdir, 'ukf_belief.npz'))
    mean, sqrt_cov = belief['mean'], belief['sqrt_cov']
  diag = np.diagonal(sqrt_cov, axis1=-2, axis2=-1)
  obs_mse = float(np.mean((obsvs - gts) ** 2))
  per_cycle_mse = [float(np.mean((p - g) ** 2)) for p, g in zip(preds, gts)]
  for i, ((meas_s, filt_s), f_mse) in enumerate(zip(seconds, per_cycle_mse)):
    log(f'  cycle {i + 1}: measurement {meas_s:.4f} s, filter {filt_s:.4f} '
        f's, f-MSE {f_mse:.4e}')
  steady = seconds[1:] or seconds
  report = dict(
      cycles=cycles, total_s=total_s, f_mse=mse, obs_mse=obs_mse,
      per_cycle_f_mse=per_cycle_mse, cycle_seconds=seconds,
      steady_measurement_s=float(np.mean([s[0] for s in steady])),
      steady_filter_s=float(np.mean([s[1] for s in steady])),
      filters=list(mean.shape), min_sqrt_cov_diag=float(diag.min()),
      launches=launches, expected_launches=expected,
      correlation_launches_by_batch=corr_batches,
      ns_step_launches_by_kernel=ns_by_kernel)
  log(f'  {cycles} cycles in {total_s:.2f} s (rollout, init and cycles); '
      f'steady cycle (cycles 2..{cycles}): measurement '
      f'{report["steady_measurement_s"]:.4f} s + filter '
      f'{report["steady_filter_s"]:.4f} s')
  log(f'  f-MSE filtered {mse:.4e} vs noisy observation {obs_mse:.4e}; '
      f'beliefs {tuple(mean.shape)}, min sqrt-cov diagonal '
      f'{report["min_sqrt_cov_diag"]:.3e}')
  log(f'  launches: {launches} (expected {expected}); K3 launches by '
      f'batch {corr_batches}, K4 by kernel {ns_by_kernel}')
  finite = bool(np.isfinite(mean).all() and np.isfinite(sqrt_cov).all()
                and np.isfinite(preds).all())
  if not finite or diag.min() < 0:
    failures.append(f'ukf: finite beliefs {finite}, min sqrt-cov diagonal '
                    f'{diag.min()}')
  if not mse < obs_mse:
    failures.append(f'ukf: filtered f-MSE {mse} not below the observation '
                    f'{obs_mse}')
  for name, n in expected.items():
    if launches[name] != n:
      failures.append(f'{name}: {launches[name]} launches, expected {n}')
  if corr_batches != {ukf_lib.N_DRAWS: expected['correlation']}:
    failures.append(f'correlation: launches by batch {corr_batches}, '
                    f'expected all {expected["correlation"]} at '
                    f'{ukf_lib.N_DRAWS}')
  if ns_by_kernel != {'smem': expected['ns_step_fused'], 'staged': 0}:
    failures.append(f'ns_step_fused: launches by kernel {ns_by_kernel}, '
                    'expected every one the one-launch kernel')
  return report, launches, failures


def check_conv_dgrad(shape, batch, seed):
  """K1 as the data gradient of the site (H, W, Cin, Cout) at ``batch``:
  dy (B, H, W, Cout) through the flipped kernel (3, 3, Cout, Cin), as the
  train step launches it, against the plain version in f32 and bf16; in
  bf16 also timed beside the library call of the same function,
  ``torch.nn.grad.conv2d_input`` (cuDNN)."""
  H, W, cin, cout = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  row = {}
  for dtype in (torch.float32, torch.bfloat16):
    dy = torch.randn((batch, H, W, cout), generator=g, device='cuda').to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=g, device='cuda') / (
        9 * cin) ** 0.5).to(dtype)
    wf = k1.flipped(w).contiguous()      # the wrapper's cast is a no-op
    name = str(dtype).split('.')[-1]
    with torch.inference_mode():
      got = k1._conv(dy, wf, None, 'data_grad')
      want = k1.conv3x3_plain(dy, wf)
      torch.cuda.synchronize()
      row[f'{name}_abs_err'], row[f'{name}_rel_err'] = rel_err(got, want)
      row[f'{name}_kernel'] = k1.kernel_for(dtype, cout, cin)
      if dtype == torch.bfloat16:
        dy_lib = dy.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row.update(timings(
            lambda: k1._conv(dy, wf, None, 'data_grad'),
            lambda: k1.conv3x3_plain(dy, wf),
            lambda: torch.nn.grad.conv2d_input(
                (batch, cin, H, W), w_lib, dy_lib, padding=1)))
        flops = 2 * 9 * batch * H * W * cin * cout
        nbytes = (dy.numel() + w.numel() + batch * H * W * cin) * 2
        row['bound_ms'], row['bound_by'] = bound(flops, nbytes, dtype)
  row.update(max_abs_err=row['bfloat16_abs_err'])
  return row


def dgrad_phase(sites, batch, seed):
  """K1's data gradient at every site shape of the train step (per step:
  one launch per forward site).  Returns (rows, per-step bf16 totals,
  failures)."""
  rows, failures = [], []
  for i, (shape, count) in enumerate(sorted(sites.items())):
    row = check_conv_dgrad(shape, batch, seed + i)
    row.update(shape=list(shape), per_step=count, batch=batch)
    rows.append(row)
    log(f'  dx of {shape} x{count} at batch {batch}: f32 '
        f'{row["float32_kernel"]} rel {row["float32_rel_err"]:.3e}, bf16 '
        f'{row["bfloat16_kernel"]} rel {row["bfloat16_rel_err"]:.3e} | '
        f'kernel {row["ms"]:.4f} ms (call {row["call_ms"]:.4f}) plain '
        f'{row["plain_ms"]:.4f} conv2d_input {row["library_ms"]:.4f} bound '
        f'{row["bound_ms"]:.4f} ({row["bound_by"]})')
    for dtype in (torch.float32, torch.bfloat16):
      name = str(dtype).split('.')[-1]
      if not row[f'{name}_rel_err'] <= TOL[dtype]:
        failures.append(f'conv3x3 dx {shape} {name}: rel '
                        f'{row[name + "_rel_err"]:.3e}')
      if row[f'{name}_kernel'] != k1.kernel_for(dtype, shape[2], shape[3]):
        failures.append(f'conv3x3 dx {shape} {name}: kernel '
                        f'{row[name + "_kernel"]} differs from the forward')
  total = {k: sum(r[k] * r['per_step'] for r in rows)
           for k in ('ms', 'call_ms', 'plain_ms', 'library_ms', 'bound_ms')}
  by = collections.Counter()
  for r in rows:
    by[r['bound_by']] += r['bound_ms'] * r['per_step']
  total.update(bound_by=by.most_common(1)[0][0],
               max_abs_err=max(r['max_abs_err'] for r in rows))
  log(f'  dx per train step (bf16, batch {batch}, device ms): kernel '
      f'{total["ms"]:.4f}, plain {total["plain_ms"]:.4f}, conv2d_input '
      f'{total["library_ms"]:.4f}, bound {total["bound_ms"]:.4f}')
  return rows, total, failures


def train_grad_phase(seed):
  """One train step's loss and gradients, kernel path against plain path,
  at the flagship's full width and batch: the same randomised parameters,
  batch, t, z and dropout generator, in f32 (TF32 off) and bf16; each
  leaf's gradient within the limit of max |plain gradient| of that leaf
  (of the largest leaf, for a leaf that is zero but for rounding).
  Returns (report, failures)."""
  out, failures = {}, []
  for dtype in (torch.float32, torch.bfloat16):
    config, kernel_model = flagship(dtype, True, seed)
    _, plain_model = flagship(dtype, False, seed)
    sde, _ = sde_lib.get_sde(config)
    batch_size, size = config.training.batch_size, config.data.image_size
    g = torch.Generator(device='cuda').manual_seed(seed)
    batch = torch.rand((batch_size, size, size, config.data.num_channels),
                       generator=g, device='cuda') * 2 - 1
    t = torch.rand((batch_size,), generator=g, device='cuda') * (
        sde.T - 1e-5) + 1e-5
    z = torch.randn(batch.shape, generator=g, device='cuda')
    results = {}
    for path, model in (('kernel', kernel_model), ('plain', plain_model)):
      params = dict(model.named_parameters())
      loss_fn = losses.get_sde_loss_fn(sde, model, True, reduce_mean=True,
                                       likelihood_weighting=False)
      dropout = torch.Generator(device='cuda').manual_seed(seed + 1)
      loss = loss_fn(params, batch, dropout, noise=(t, z))
      grads = torch.autograd.grad(loss, list(params.values()))
      results[path] = (float(loss.detach()), dict(zip(params, grads)))
      del loss, grads
    (k_loss, k_grads), (p_loss, p_grads) = results['kernel'], results['plain']
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    # A leaf whose gradient is zero but for rounding (an attention block's
    # key bias: softmax ignores it) is held relative to the largest leaf;
    # the f32 run finds them, the bf16 run (whose rounding is larger)
    # takes the same leaves.
    top = max(float(v.abs().max()) for v in p_grads.values())
    if dtype == torch.float32:
      zero = [n for n, v in p_grads.items()
              if float(v.abs().max()) < ZERO_LEAF * top]
    leaf_errs = {n: float((k_grads[n].float() - p_grads[n].float()).abs()
                          .max()) / (top if n in zero
                                     else float(p_grads[n].abs().max()))
                 for n in p_grads}
    worst = sorted(leaf_errs, key=leaf_errs.get, reverse=True)[:3]
    finite = all(bool(torch.isfinite(v).all()) for v in k_grads.values())
    name = str(dtype).split('.')[-1]
    out[name] = dict(loss_kernel=k_loss, loss_plain=p_loss, loss_rel=loss_rel,
                     max_leaf_rel=leaf_errs[worst[0]],
                     worst_leaves={n: leaf_errs[n] for n in worst},
                     leaves=len(leaf_errs), zero_leaves=zero,
                     tol=TOL[dtype])
    log(f'  train-step gradients {name}, batch {batch_size}: loss kernel '
        f'{k_loss:.6f} plain {p_loss:.6f} (rel {loss_rel:.2e}); '
        f'{len(leaf_errs)} leaves ({len(zero)} zero but for rounding, '
        f'held relative to the largest: {zero[:3]}...), worst rel '
        + ', '.join(f'{n} {leaf_errs[n]:.2e}' for n in worst)
        + f' (limit {TOL[dtype]})')
    if not (finite and loss_rel <= TOL[dtype]
            and leaf_errs[worst[0]] <= TOL[dtype]):
      failures.append(f'train-step gradients {name}: loss rel '
                      f'{loss_rel:.3e}, worst leaf {worst[0]} '
                      f'{leaf_errs[worst[0]]:.3e}, finite {finite}')
    del kernel_model, plain_model, results, k_grads, p_grads
    torch.cuda.empty_cache()
  return out, failures


def train_phase(steps, train_steps, per_forward, seed):
  """``run_lib.train`` at the flagship's full width, batch 128, bf16, for
  ``train_steps`` + 1 steps with the cadence cut so that log, eval, the
  preemption checkpoint and a snapshot (sampling at N = ``steps``) fire;
  the launch counts set to 0 before and read after; then a second call
  that resumes from the preemption checkpoint.  Returns (report,
  launches, failures)."""
  config = configs.get_config(CONFIG)
  config.model.num_scales = steps
  t = config.training
  t.n_iters = train_steps
  t.log_freq = 10
  t.eval_freq = train_steps // 2
  t.snapshot_freq_for_preemption = train_steps // 2
  t.snapshot_freq = train_steps
  failures, history = [], []
  with tempfile.TemporaryDirectory() as workdir:
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start = time.time()
    state = run_lib.train(config, workdir, device='cuda', history=history)
    torch.cuda.synchronize()
    total_s = time.time() - start
    peak = torch.cuda.max_memory_allocated()
    launches = {'conv3x3': k1.conv3x3.launches,
                'groupnorm_act': k2.groupnorm_act.launches}
    by_kernel = dict(k1.conv3x3.launches_by_kernel)
    by_use = dict(k1.conv3x3.launches_by_use)
    fired = collections.Counter(e for h in history for e in h['events'])
    n_steps = len(history)
    forwards = n_steps + fired['eval'] + fired['snapshot'] * steps
    expected = {'conv3x3': per_forward['conv3x3'] * (forwards + n_steps),
                'groupnorm_act': per_forward['groupnorm_act'] * forwards}
    expected_use = {'forward': per_forward['conv3x3'] * forwards,
                    'data_grad': per_forward['conv3x3'] * n_steps}
    sample = os.path.join(workdir, 'samples', f'iter_{train_steps}',
                          'sample.np')
    sample_shape = (list(np.load(sample).shape) if os.path.exists(sample)
                    else None)

    # The parameters moved from the init; the EMA step on one leaf.
    init = registry.create_model(config, device='cuda', seed=config.seed)
    moved = sum(not torch.equal(p, state.params[n])
                for n, p in init.named_parameters())
    leaf = 'ResnetBlockDDPM_0.Conv3x3_0.Conv_0.kernel'
    e_before = state.ema_params[leaf].clone()
    decay = state_lib.ema_decay(state.step, state.ema_rate)
    step_fn = losses.get_step_fn(
        sde_lib.get_sde(config)[0], init, losses.get_optimizer(config),
        train=True, reduce_mean=t.reduce_mean, continuous=True)
    g = torch.Generator(device='cuda').manual_seed(seed)
    size = config.data.image_size
    batch = torch.rand((t.batch_size, size, size, config.data.num_channels),
                       generator=g, device='cuda') * 2 - 1
    state, _ = step_fn(state, batch, g)
    want = e_before - (1 - decay) * (e_before - state.params[leaf].detach())
    ema_err = rel_err(state.ema_params[leaf], want)[1]
    # One steady step under the profiler.
    step_fn(state, batch, g)
    profile_out, _ = profiled('train step (batch 128, bf16)',
                              lambda: step_fn(state, batch, g))
    del init, state

    t.n_iters = train_steps + 4
    t.snapshot_sampling = False
    resumed_history = []
    resumed = run_lib.train(config, workdir, device='cuda',
                            history=resumed_history)
    resumed_steps = [h['step'] for h in resumed_history]
    resumed_final = resumed.step
    del resumed

  # The host's share: one batch assembled by the loader (the synthetic
  # CIFAR-10 stand-in), as every step does before its update.
  it = iter(get_dataset(config)[0])
  next(it)
  start = time.perf_counter()
  for _ in range(5):
    next(it)
  batch_s = (time.perf_counter() - start) / 5

  steady = [h['seconds'] for h in history[2:] if not h['events']]
  step_s = float(np.mean(steady))
  losses_ = [h['loss'] for h in history]
  report = dict(
      steps=n_steps, events=dict(fired), total_s=total_s,
      steady_step_s=step_s, batch_assembly_s=batch_s, steps_per_s=1 / step_s,
      imgs_per_s=t.batch_size / step_s, steady_steps_timed=len(steady),
      first_step_s=history[0]['seconds'],
      event_step_s={h['step']: h['seconds'] for h in history if h['events']},
      losses=losses_, max_memory_allocated=peak, launches=launches,
      expected_launches=expected, conv3x3_by_kernel=by_kernel,
      conv3x3_by_use=by_use, expected_by_use=expected_use,
      params_moved=moved, ema_rel_err=ema_err, sample_shape=sample_shape,
      resumed_steps=resumed_steps, resumed_final_step=resumed_final,
      profile=profile_out)
  log(f'  {n_steps} steps in {total_s:.2f} s (events {dict(fired)}); steady '
      f'step {step_s:.4f} s (mean of {len(steady)} event-free steps after '
      f'the first two, synchronised): {1 / step_s:.3f} steps/s, '
      f'{t.batch_size / step_s:.1f} imgs/s; first step '
      f'{history[0]["seconds"]:.2f} s; of a step, the batch\'s assembly '
      f'on the host {batch_s:.4f} s')
  log(f'  losses: first {losses_[0]:.5f}, last {losses_[-1]:.5f}, all '
      f'finite {bool(np.isfinite(losses_).all())}; peak memory '
      f'{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)')
  log(f'  launches {launches} (expected {expected}), conv3x3 by kernel '
      f'{by_kernel}, by use {by_use} (expected {expected_use})')
  log(f'  parameters moved from the init: {moved} leaves; EMA step on '
      f'{leaf}: rel {ema_err:.2e}; samples {sample_shape}; resumed at '
      f'{resumed_steps[:1]} to step {resumed_final}')
  if not np.isfinite(losses_).all():
    failures.append('train: a loss is not finite')
  for name, n in expected.items():
    if launches[name] != n:
      failures.append(f'train {name}: {launches[name]} launches, expected '
                      f'{n}')
  if by_use != expected_use:
    failures.append(f'train conv3x3 by use {by_use}, expected {expected_use}')
  if by_kernel['direct'] or by_kernel['wgmma'] != launches['conv3x3']:
    failures.append(f'train conv3x3: bf16 sites left the wgmma kernel: '
                    f'{by_kernel}')
  if not moved:
    failures.append('train: no parameter moved')
  if not ema_err <= 1e-6:
    failures.append(f'train: EMA step rel error {ema_err:.3e}')
  if sample_shape != [t.batch_size // 4, size, size,
                      config.data.num_channels]:
    failures.append(f'train: snapshot samples {sample_shape}')
  want_resumed = list(range(train_steps + 1, train_steps + 5))
  if resumed_steps != want_resumed or resumed_final != train_steps + 5:
    failures.append(f'train: resumed steps {resumed_steps}, final '
                    f'{resumed_final}; expected {want_resumed}')
  return report, launches, failures


PRELIM_CONFIG = 'pinn/pinn_pde'


def check_corr_bwd(shape, seed):
  """K3's backward at (B, H, W, C), f32: B1 and B2 against their plain
  versions (each kernel twice for its bits) and timed; one second-order
  product, ``autograd.grad`` of ``((df1 + df2) * r).sum()`` taken with
  ``create_graph``, in f1, f2 and dout, against autograd of the plain
  cost volume."""
  B, H, W, C = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  d = torch.randn((B, H, W, 49), generator=g, device='cuda')
  a = torch.randn(shape, generator=g, device='cuda')
  row = {}
  for name, fn, plain in (
      ('df1', k3.correlation_df1, k3.correlation_df1_plain),
      ('df2', k3.correlation_df2, k3.correlation_df2_plain)):
    with torch.inference_mode():
      got, again, want = fn(d, a), fn(d, a), plain(d, a)
      torch.cuda.synchronize()
      abs_err, rel = rel_err(got, want)
      times = timings(lambda: fn(d, a), lambda: plain(d, a))
    row[name] = dict(times, max_abs_err=abs_err, rel_err=rel,
                     same_bits_twice=bool(torch.equal(got, again)))
  f1, f2, r = (torch.randn(shape, generator=g, device='cuda')
               for _ in range(3))
  dout = torch.randn((B, H, W, 49), generator=g, device='cuda')
  results = []
  for fn in (k3.correlation, k3.correlation_plain):
    leaves = [t.clone().requires_grad_() for t in (f1, f2, dout)]
    d1, d2 = torch.autograd.grad(fn(leaves[0], leaves[1]), leaves[:2],
                                 leaves[2], create_graph=True)
    results.append(torch.autograd.grad(((d1 + d2) * r).sum(), leaves))
  row['second_order_rel_err'] = max(rel_err(x, y)[1]
                                    for x, y in zip(*results))
  pixels = B * H * W
  # Per kernel: d and g read once, the gradient written once; 49 C
  # multiply-adds a pixel.
  row['bound_ms'], row['bound_by'] = bound(
      2 * 49 * C * pixels, (49 + 2 * C) * pixels * 4, torch.float32)
  for k in ('ms', 'call_ms', 'plain_ms'):
    row[k] = row['df1'][k] + row['df2'][k]
  row['bound_ms'] *= 2
  row['max_abs_err'] = max(row['df1']['max_abs_err'],
                           row['df2']['max_abs_err'])
  row['rel_err'] = max(row['df1']['rel_err'], row['df2']['rel_err'])
  return row


def corr_bwd_phase(seed):
  """K3's backward at the prelim step's five level shapes at batch 64
  (one B1 and one B2 launch each a step) and at an odd shape.  Returns
  (rows, per-step totals, failures)."""
  config = configs.get_config(PRELIM_CONFIG)
  size, batch = config.data.image_size, config.training.batch_size
  shapes = ([((batch, size >> (i + 1), size >> (i + 1), c), 1)
             for i, c in enumerate(config.model.feature_nums)]
            + [((3, 13, 11, 24), 0)])
  rows, failures = [], []
  tol = TOL[torch.float32]
  for i, (shape, per_step) in enumerate(shapes):
    row = check_corr_bwd(shape, seed + i)
    row.update(shape=list(shape), per_step=per_step, tol=tol)
    rows.append(row)
    log(f'  B1+B2 {shape} x{per_step} rel df1 {row["df1"]["rel_err"]:.3e} '
        f'df2 {row["df2"]["rel_err"]:.3e} second order '
        f'{row["second_order_rel_err"]:.3e} | kernels {row["ms"]:.4f} ms '
        f'(df1 {row["df1"]["ms"]:.4f}, df2 {row["df2"]["ms"]:.4f}; calls '
        f'{row["call_ms"]:.4f}) plain {row["plain_ms"]:.4f} bound '
        f'{row["bound_ms"]:.6f} ({row["bound_by"]})')
    for key in ('df1', 'df2'):
      if not row[key]['rel_err'] <= tol:
        failures.append(f'correlation {key} {shape}: rel '
                        f'{row[key]["rel_err"]:.3e}')
      if not row[key]['same_bits_twice']:
        failures.append(f'correlation {key} {shape}: two runs differ')
    if not row['second_order_rel_err'] <= tol:
      failures.append(f'correlation second order {shape}: rel '
                      f'{row["second_order_rel_err"]:.3e}')
  total = {k: sum(r[k] * r['per_step'] for r in rows)
           for k in ('ms', 'call_ms', 'plain_ms', 'bound_ms')}
  total.update(bound_by='bytes', library_ms=None,
               max_abs_err=max(r['max_abs_err'] for r in rows))
  log(f'  per prelim step (f32, batch {batch}, device ms): B1+B2 kernels '
      f'{total["ms"]:.4f} in {2 * len(config.model.feature_nums)} launches, '
      f'plain {total["plain_ms"]:.4f}, bound {total["bound_ms"]:.6f}')
  return rows, total, failures


def prelim_batch(config, seed):
  """A full-width batch, mask and the frames' noise, from a seed."""
  g = torch.Generator(device='cuda').manual_seed(seed)
  B, S = config.training.batch_size, config.data.image_size
  frames = [torch.rand((B, S, S, 1), generator=g, device='cuda')
            for _ in range(4)]
  batch = tuple(frames) + (
      torch.arange(1, B + 1, device='cuda', dtype=torch.float32),
      0.5 * torch.randn((B, S, S, 3), generator=g, device='cuda'))
  mask = (torch.rand((S, S, 1), generator=g, device='cuda') < 0.9).float()
  noise = tuple(torch.randn((B, S, S, 1), generator=g, device='cuda')
                for _ in range(2))
  return batch, mask, noise


def prelim_grad_phase(seed):
  """One prelim loss's gradients at full width, kernel path (K3 and its
  backward) against plain path (the plain cost volume under autograd):
  the same randomised parameters, batch, mask and noise.  The loss within
  the limit of itself, every leaf within the limit of the largest leaf's
  gradient.  Returns (report, failures)."""
  config = configs.get_config(PRELIM_CONFIG)
  models = {}
  for path, kernels in (('kernel', True), ('plain', False)):
    models[path] = PINN(config, kernels=kernels).cuda()
    randomize_(models[path], seed)
  batch, mask, noise = prelim_batch(config, seed)
  results = {}
  for path, model in models.items():
    params = dict(model.named_parameters())
    loss, v_loss, p_loss = pinn_losses.get_prelim_loss_fn(config, model)(
        params, mask, batch, noise=noise)
    grads = torch.autograd.grad(loss, list(params.values()))
    results[path] = ([float(v.detach()) for v in (loss, v_loss, p_loss)],
                     dict(zip(params, grads)))
  (k_losses, k_grads), (p_losses, p_grads) = (results['kernel'],
                                              results['plain'])
  loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses))
  top = max(float(v.abs().max()) for v in p_grads.values())
  leaf_errs = {n: float((k_grads[n] - p_grads[n]).abs().max()) / top
               for n in p_grads}
  own_errs = {n: float((k_grads[n] - p_grads[n]).abs().max())
              / max(float(p_grads[n].abs().max()), 1e-30) for n in p_grads}
  worst = sorted(leaf_errs, key=leaf_errs.get, reverse=True)[:3]
  worst_own = max(own_errs, key=own_errs.get)
  finite = all(bool(torch.isfinite(v).all()) for v in k_grads.values())
  tol = TOL[torch.float32]
  out = dict(losses_kernel=k_losses, losses_plain=p_losses,
             loss_rel=loss_rel, max_leaf_rel=leaf_errs[worst[0]],
             worst_leaves={n: leaf_errs[n] for n in worst},
             worst_own_leaf=(worst_own, own_errs[worst_own]),
             leaves=len(leaf_errs), tol=tol)
  log(f'  prelim gradients f32, batch {config.training.batch_size}: (loss, '
      f'v, p) kernel {k_losses} plain {p_losses} (rel {loss_rel:.2e}); '
      f'{len(leaf_errs)} leaves, worst rel to the largest leaf '
      + ', '.join(f'{n} {leaf_errs[n]:.2e}' for n in worst)
      + f' (limit {tol}); worst rel to its own leaf {worst_own} '
      f'{own_errs[worst_own]:.2e}')
  failures = []
  if not (finite and loss_rel <= tol and leaf_errs[worst[0]] <= tol):
    failures.append(f'prelim gradients: loss rel {loss_rel:.3e}, worst leaf '
                    f'{worst[0]} {leaf_errs[worst[0]]:.3e}, finite {finite}')
  del models, results, k_grads, p_grads
  torch.cuda.empty_cache()
  return out, failures


def prelim_phase(prelim_steps, seed):
  """``pinn_lib.train_prelim`` at pinn_pde's full width for steps
  0..``prelim_steps`` with the cadence cut so that log, eval, the
  preemption checkpoint and a snapshot fire, on a rollout made anew in
  an empty data directory; the launch counts set to 0 before and read
  after; then a resume from the preemption checkpoint.  Returns (report,
  launches, failures)."""
  config = configs.get_config(PRELIM_CONFIG)
  t = config.training
  t.n_iters = prelim_steps
  t.log_freq = 10
  t.eval_freq = prelim_steps // 2
  t.snapshot_freq_for_preemption = prelim_steps // 2
  t.snapshot_freq = prelim_steps
  levels = len(config.model.feature_nums)
  frames = max(int(config.data.time_trim) + 64, 400)
  failures, history = [], []
  data_dir = os.environ.get('BPKF_DATA_DIR')
  with tempfile.TemporaryDirectory() as tmp:
    os.environ['BPKF_DATA_DIR'] = os.path.join(tmp, 'data')
    workdir = os.path.join(tmp, 'work')
    try:
      reset_counts()
      torch.cuda.reset_peak_memory_stats()
      torch.cuda.synchronize()
      start = time.time()
      state = pinn_lib.train_prelim(config, workdir, device='cuda',
                                    history=history)
      torch.cuda.synchronize()
      total_s = time.time() - start
      peak = torch.cuda.max_memory_allocated()
      launches = {'correlation': k3.correlation.launches,
                  'correlation_df1': k3.correlation_df1.launches,
                  'correlation_df2': k3.correlation_df2.launches,
                  'ns_step_fused': k4.ns_step_fused.launches}
      corr_batches = dict(k3.correlation.batches)
      fired = collections.Counter(e for h in history for e in h['events'])
      n_steps = len(history)
      expected = {'correlation': levels * (n_steps + fired['eval']),
                  'correlation_df1': levels * n_steps,
                  'correlation_df2': levels * n_steps,
                  'ns_step_fused': frames - 1}
      snapshots = sorted(os.listdir(os.path.join(workdir, 'checkpoints')))

      # The parameters moved from the init; then one steady step profiled.
      model, _ = init_pinn(config, device='cuda')
      init = dict(model.named_parameters())
      moved = sum(not torch.equal(init[n], p)
                  for n, p in state.params.items())
      n_leaves = len(init)
      tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.001)
      step_fn = pinn_losses.get_prelim_step_fn(config, model, tx, train=True)
      batch, mask, _ = prelim_batch(config, seed)
      g = torch.Generator(device='cuda').manual_seed(seed)
      step_fn(state, mask, batch, g)
      profile_out, _ = profiled(
          'prelim train step (batch 64, f32)',
          lambda: step_fn(state, mask, batch, g))
      del model, init, state

      t.n_iters = prelim_steps + 4
      resumed_history = []
      resumed = pinn_lib.train_prelim(config, workdir, device='cuda',
                                      history=resumed_history)
      resumed_steps = [h['step'] for h in resumed_history]
      resumed_final = resumed.step
      del resumed

      # The host's share: one batch assembled by the loader, as every
      # step does before its update (the rollout is cached by now).
      it = iter(get_dataset(config, device='cuda')[0])
      next(it)
      start = time.perf_counter()
      for _ in range(5):
        next(it)
      batch_s = (time.perf_counter() - start) / 5
    finally:
      if data_dir is None:
        os.environ.pop('BPKF_DATA_DIR', None)
      else:
        os.environ['BPKF_DATA_DIR'] = data_dir

  steady = [h['seconds'] for h in history[2:] if not h['events']]
  step_s = float(np.mean(steady))
  losses_ = [h['loss'] for h in history]
  bs = t.batch_size
  report = dict(
      steps=n_steps, events=dict(fired), total_s=total_s,
      steady_step_s=step_s, samples_per_s=bs / step_s,
      steady_steps_timed=len(steady), batch_assembly_s=batch_s,
      first_step_s=history[0]['seconds'],
      event_step_s={h['step']: h['seconds'] for h in history if h['events']},
      losses=losses_, max_memory_allocated=peak, launches=launches,
      expected_launches=expected, correlation_launches_by_batch=corr_batches,
      snapshots=snapshots, params_moved=moved,
      resumed_steps=resumed_steps, resumed_final_step=resumed_final,
      profile=profile_out)
  log(f'  {n_steps} steps in {total_s:.2f} s (the rollout and data set-up '
      f'included; events {dict(fired)}); steady step {step_s:.4f} s (mean '
      f'of {len(steady)} event-free steps after the first two, '
      f'synchronised): {bs / step_s:.1f} samples/s; first step '
      f'{history[0]["seconds"]:.2f} s; of a step, the batch\'s assembly on '
      f'the host {batch_s:.4f} s')
  log(f'  losses: first {losses_[0]:.5f}, last {losses_[-1]:.5f}, all finite '
      f'{bool(np.isfinite(losses_).all())}; peak memory {peak / 2**30:.2f} '
      'GiB (torch.cuda.max_memory_allocated)')
  log(f'  launches {launches} (expected {expected}); K3 by batch '
      f'{corr_batches}; snapshots {snapshots}; parameters moved '
      f'{moved} of {n_leaves}; resumed at '
      f'{resumed_steps[:1]} to step {resumed_final}')
  if not np.isfinite(losses_).all():
    failures.append('prelim: a loss is not finite')
  for name, n in expected.items():
    if launches[name] == 0 or launches[name] != n:
      failures.append(f'prelim {name}: {launches[name]} launches, expected '
                      f'{n}')
  if snapshots != ['checkpoint_1']:
    failures.append(f'prelim: snapshots {snapshots}')
  if not moved:
    failures.append('prelim: no parameter moved')
  want_resumed = list(range(prelim_steps + 1, prelim_steps + 5))
  if resumed_steps != want_resumed or resumed_final != prelim_steps + 5:
    failures.append(f'prelim: resumed steps {resumed_steps}, final '
                    f'{resumed_final}; expected {want_resumed}')
  return report, launches, failures


PINN_CONFIG = 'pinn/pinn_pde'
# K3 at third order against autograd of the plain cost volume: the
# limit relative to max |plain| (the second-order products hold to 4.5e-7).
THIRD_ORDER_TOL = 1e-5
FLOW_KERNELS = (('correlation', k3.correlation),
                ('correlation_df1', k3.correlation_df1),
                ('correlation_df2', k3.correlation_df2))


def flow_counts():
  """K3's, B1's and B2's launch counts, by name."""
  return {name: fn.launches for name, fn in FLOW_KERNELS}


def check_corr_third(shape, seed):
  """K3 at third order at (B, H, W, C): the gradient in f1, f2 and dout of
  a seeded linear functional of ``check_corr_bwd``'s second-order product,
  through K3, B1 and B2, against autograd of the plain cost volume.
  Returns the worst of the three gradients' errors relative to max
  |plain|."""
  B, H, W, C = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  f1, f2, r, q1, q2 = (torch.randn(shape, generator=g, device='cuda')
                       for _ in range(5))
  dout, q3 = (torch.randn((B, H, W, 49), generator=g, device='cuda')
              for _ in range(2))
  results = []
  for fn in (k3.correlation, k3.correlation_plain):
    leaves = [t.clone().requires_grad_() for t in (f1, f2, dout)]
    d1, d2 = torch.autograd.grad(fn(leaves[0], leaves[1]), leaves[:2],
                                 leaves[2], create_graph=True)
    second = torch.autograd.grad(((d1 + d2) * r).sum(), leaves,
                                 create_graph=True)
    results.append(torch.autograd.grad(
        sum((a * b).sum() for a, b in zip(second, (q1, q2, q3))), leaves))
  return max(rel_err(x, y)[1] for x, y in zip(*results))


def corr_third_phase(seed):
  """K3 at third order at the five level shapes at batch 64 and an odd
  shape.  Returns (rows, failures)."""
  config = configs.get_config(PINN_CONFIG)
  size, batch = config.data.image_size, config.training.batch_size
  shapes = ([(batch, size >> (i + 1), size >> (i + 1), c)
             for i, c in enumerate(config.model.feature_nums)]
            + [(3, 13, 11, 24)])
  rows, failures = [], []
  for i, shape in enumerate(shapes):
    rel = check_corr_third(shape, seed + i)
    rows.append(dict(shape=list(shape), third_order_rel_err=rel,
                     tol=THIRD_ORDER_TOL))
    log(f'  K3, B1, B2 third order {shape}: rel {rel:.3e} (limit '
        f'{THIRD_ORDER_TOL})')
    if not rel <= THIRD_ORDER_TOL:
      failures.append(f'correlation third order {shape}: rel {rel:.3e}')
  return rows, failures


def pinn_batch(config, seed):
  """``prelim_batch`` with the coordinates a unit grid per image jittered
  by up to 0.01 (no pixel where the spatial embedding's sqrt has its 1e6
  second derivative)."""
  batch, mask, noise = prelim_batch(config, seed)
  g = torch.Generator(device='cuda').manual_seed(seed + 1)
  B, S = config.training.batch_size, config.data.image_size
  grid = torch.linspace(0, 1, S, device='cuda')
  x = grid[None, None, :, None] + 0.01 * torch.rand(
      (B, S, S, 1), generator=g, device='cuda')
  y = grid[None, :, None, None] + 0.01 * torch.rand(
      (B, S, S, 1), generator=g, device='cuda')
  return batch[:2] + (x, y) + batch[4:], mask, noise


def leaf_errors(got, want):
  """Each leaf's max error relative to the largest leaf of ``want``; the
  three worst."""
  top = max(float(v.abs().max()) for v in want.values())
  errs = {n: float((got[n] - w).abs().max()) / top for n, w in want.items()}
  worst = sorted(errs, key=errs.get, reverse=True)[:3]
  return errs[worst[0]], {n: errs[n] for n in worst}


def pinn_grad_phase(seed):
  """One phase-2 loss at full width, kernel path (K3, B1, B2 to third
  order) against plain path (the plain cost volume under autograd): the
  same randomised parameters, batch, mask and noise.  Compares the
  residual and the data loss, the gradient of the residual alone (at the
  loss weight 1e-5 a wrong one would vanish in the total; leaves it does
  not reach are zeros) and the total gradient, every leaf within the
  limit of the largest leaf's gradient; counts the kernel path's launches
  by stage of the residual, by level, for one train step and for one eval
  step.  Returns (report, failures)."""
  config = configs.get_config(PINN_CONFIG)
  batch, mask, noise = pinn_batch(config, seed)
  f1m, f2m = pinn_losses.masked_frames(config, batch, mask, None, noise)
  _, _, x, y, t, _ = batch
  out, results = {}, {}
  for path, kernels in (('kernel', True), ('plain', False)):
    model = PINN(config, kernels=kernels).cuda()
    randomize_(model, seed)
    params = dict(model.named_parameters())
    stages = []

    def trace(stage):
      stages.append((stage, flow_counts()))

    reset_counts()
    residual = equation_mse_from_outputs(
        model, params, f1m, f2m, x, y, t, pinn_losses.RE, trace=trace)
    g_res = torch.autograd.grad(residual, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    trace('parameter gradient')
    del residual
    reset_counts()
    loss_fn = pinn_losses.get_pinn_loss_fn(config, model)
    loss, pinn_loss, data_loss = loss_fn(params, mask, batch, noise=noise)
    g_all = torch.autograd.grad(loss, list(params.values()))
    step_counts = flow_counts()
    step_sizes = {name: {f'{h}x{w}': n for (h, w), n in fn.sizes.items()}
                  for name, fn in FLOW_KERNELS}
    reset_counts()
    loss_fn(params, mask, batch, noise=noise, create_graph=False)
    eval_counts = flow_counts()
    torch.cuda.synchronize()
    results[path] = dict(
        values=[float(v.detach()) for v in (loss, pinn_loss, data_loss)],
        residual=dict(zip(params, g_res)), total=dict(zip(params, g_all)))
    if kernels:
      out.update(stages=stages, step_launches=step_counts,
                 step_launches_by_size=step_sizes, eval_launches=eval_counts)
    del model, params, g_res, g_all, loss, pinn_loss, data_loss
    torch.cuda.empty_cache()
  k, p = results['kernel'], results['plain']
  tol = TOL[torch.float32]
  value_rel = [abs(a - b) / abs(b) for a, b in zip(k['values'], p['values'])]
  failures = []
  out.update(values_kernel=k['values'], values_plain=p['values'],
             value_rel=value_rel, tol=tol)
  for which in ('residual', 'total'):
    worst, top3 = leaf_errors(k[which], p[which])
    finite = all(bool(torch.isfinite(v).all()) for v in k[which].values())
    out[f'{which}_grad'] = dict(max_leaf_rel=worst, worst_leaves=top3,
                                finite=finite, leaves=len(k[which]))
    log(f'  {which} gradient, kernel vs plain: worst leaf rel to the '
        'largest leaf ' + ', '.join(f'{n} {e:.2e}' for n, e in top3.items())
        + f' (limit {tol}), finite {finite}')
    if not (finite and worst <= tol):
      failures.append(f'phase-2 {which} gradient: worst leaf {worst:.3e}, '
                      f'finite {finite}')
  log(f'  (loss, pinn_loss, data_loss) kernel {k["values"]} plain '
      f'{p["values"]} (rel {[f"{v:.2e}" for v in value_rel]})')
  if not max(value_rel) <= tol:
    failures.append(f'phase-2 losses: rel {max(value_rel):.3e}')
  log('  launches of the residual\'s gradient by stage (cumulative): '
      + '; '.join(f'{stage} {counts}' for stage, counts in out['stages']))
  log(f'  launches of one train step {out["step_launches"]}, by image size '
      f'{out["step_launches_by_size"]}; of one eval step '
      f'{out["eval_launches"]}')
  return out, failures


def pinn_phase(pinn_steps, per_step, per_eval, seed):
  """``pinn_lib.train`` at pinn_pde's full width: phase 1 for steps 0..2,
  phase 2 for steps 2..2 + ``pinn_steps`` with the cadence cut so that
  log, eval, the ``checkpoint_pinn`` preemption checkpoint and a snapshot
  fire in phase 2, on a rollout made anew in an empty data directory;
  the launch counts set to 0 before and read after, against the train
  and eval steps' counts of ``pinn_grad_phase`` (``per_step``,
  ``per_eval``); then a resume.  Returns (report, launches, failures)."""
  config = configs.get_config(PINN_CONFIG)
  t = config.training
  t.n_iters = 2
  t.n_pinn_iters = pinn_steps
  t.log_freq = pinn_steps // 2
  t.eval_freq = pinn_steps // 2
  t.snapshot_freq_for_preemption = pinn_steps // 2
  t.snapshot_freq = pinn_steps
  levels = len(config.model.feature_nums)
  frames = max(int(config.data.time_trim) + 64, 400)
  failures, history = [], []
  data_dir = os.environ.get('BPKF_DATA_DIR')
  with tempfile.TemporaryDirectory() as tmp:
    os.environ['BPKF_DATA_DIR'] = os.path.join(tmp, 'data')
    workdir = os.path.join(tmp, 'work')
    try:
      reset_counts()
      torch.cuda.reset_peak_memory_stats()
      torch.cuda.synchronize()
      start = time.time()
      state = pinn_lib.train(config, workdir, device='cuda', history=history)
      torch.cuda.synchronize()
      total_s = time.time() - start
      peak = torch.cuda.max_memory_allocated()
      launches = dict(flow_counts(),
                      ns_step_fused=k4.ns_step_fused.launches)
      phases = {tag: [h for h in history if h['phase'] == tag]
                for tag in ('prelim', 'pinn')}
      evals = {tag: sum('eval' in h['events'] for h in hs)
               for tag, hs in phases.items()}
      expected = {name: levels * (len(phases['prelim'])
                                  + (name == 'correlation') * evals['prelim'])
                  + per_step[name] * len(phases['pinn'])
                  + per_eval[name] * evals['pinn']
                  for name in per_step}
      expected['ns_step_fused'] = frames - 1
      fired = collections.Counter(e for h in phases['pinn']
                                  for e in h['events'])
      snapshots = sorted(os.listdir(os.path.join(workdir, 'checkpoints')))
      phase1_end = torch.load(os.path.join(workdir, 'checkpoints',
                                           'checkpoint_0'),
                              map_location='cuda', weights_only=True)
      moved = sum(not torch.equal(phase1_end['params'][n], v)
                  for n, v in state.params.items())
      n_leaves = len(state.params)
      counts = {label: s.count for label, s in state.opt_state.items()}
      final_step = state.step
      pinn_meta = os.path.exists(os.path.join(workdir, 'checkpoints-meta',
                                              'checkpoint_pinn'))

      # One steady phase-2 step profiled, on the trained state.
      model, _ = init_pinn(config, device='cuda')
      tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.005)
      step_fn = pinn_losses.get_pinn_step_fn(config, model, tx, train=True)
      batch, mask, _ = pinn_batch(config, seed)
      g = torch.Generator(device='cuda').manual_seed(seed)
      step_fn(state, mask, batch, g)
      profile_out, _ = profiled(
          'phase-2 train step (batch 64, f32)',
          lambda: step_fn(state, mask, batch, g))
      del model, state, phase1_end

      t.n_pinn_iters = pinn_steps + 2
      resumed_history = []
      resumed = pinn_lib.train(config, workdir, device='cuda',
                               history=resumed_history)
      resumed_steps = [(h['phase'], h['step']) for h in resumed_history]
      resumed_final = resumed.step
      del resumed
    finally:
      if data_dir is None:
        os.environ.pop('BPKF_DATA_DIR', None)
      else:
        os.environ['BPKF_DATA_DIR'] = data_dir

  steady = [h['seconds'] for h in phases['pinn'][2:] if not h['events']]
  step_s = float(np.mean(steady))
  losses_ = [h['loss'] for h in history]
  bs = t.batch_size
  families = profile_out['families']
  report = dict(
      steps={tag: [h['step'] for h in hs] for tag, hs in phases.items()},
      events=dict(fired), total_s=total_s, steady_step_s=step_s,
      samples_per_s=bs / step_s, steady_steps_timed=len(steady),
      first_step_s=phases['pinn'][0]['seconds'],
      event_step_s={h['step']: h['seconds'] for h in phases['pinn']
                    if h['events']},
      losses=losses_, max_memory_allocated=peak, launches=launches,
      expected_launches=expected, snapshots=snapshots, params_moved=moved,
      leaves=n_leaves, adam_counts=counts,
      final_step=final_step, resumed_steps=resumed_steps,
      resumed_final_step=resumed_final, profile=profile_out,
      k3_device_ms=families.get('K3 correlation', (0, 0.0))[1],
      k3_bwd_device_ms=families.get('K3 correlation backward', (0, 0.0))[1])
  n_pinn = len(phases['pinn'])
  log(f'  {len(history)} steps in {total_s:.2f} s (the rollout and data '
      f'set-up included; phase-2 events {dict(fired)}); phase-2 steady step '
      f'{step_s:.4f} s (mean of {len(steady)} event-free steps after the '
      f'first two, synchronised): {bs / step_s:.2f} samples/s; its first '
      f'step {phases["pinn"][0]["seconds"]:.2f} s')
  log(f'  losses: phase 1 first {losses_[0]:.5f}, phase 2 first '
      f'{phases["pinn"][0]["loss"]:.5f}, last {losses_[-1]:.5f}, all finite '
      f'{bool(np.isfinite(losses_).all())}; peak memory '
      f'{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)')
  log(f'  launches {launches} (expected {expected}); snapshots {snapshots}; '
      f'parameters moved in phase 2 {moved} of {report["leaves"]}; Adam '
      f'counts {counts} after {n_pinn} phase-2 steps; final step '
      f'{final_step}; resumed {resumed_steps} to step {resumed_final}')
  log(f'  profiled step: K3 {report["k3_device_ms"]:.3f} ms, B1 + B2 '
      f'{report["k3_bwd_device_ms"]:.3f} ms of device time')
  if not np.isfinite(losses_).all():
    failures.append('phase 2: a loss is not finite')
  for name, n in expected.items():
    if launches[name] == 0 or launches[name] != n:
      failures.append(f'phase 2 {name}: {launches[name]} launches, expected '
                      f'{n}')
  want_steps = {'prelim': [0, 1, 2], 'pinn': list(range(2, 3 + pinn_steps))}
  if report['steps'] != want_steps or final_step != 3 + pinn_steps:
    failures.append(f'phase 2: steps {report["steps"]}, final {final_step}')
  if set(fired) != {'log', 'eval', 'preempt_ckpt', 'snapshot'} or not (
      pinn_meta):
    failures.append(f'phase 2: events {dict(fired)}, checkpoint_pinn '
                    f'{pinn_meta}')
  if snapshots != ['checkpoint_0', 'checkpoint_1']:
    failures.append(f'phase 2: snapshots {snapshots}')
  if moved != report['leaves']:
    failures.append(f'phase 2: {moved} of {report["leaves"]} leaves moved')
  if counts != {'flow': n_pinn, 'pres': n_pinn}:
    failures.append(f'phase 2: Adam counts {counts}, expected {n_pinn}')
  # The resume re-runs phase 1 after its last preemption checkpoint, then
  # phase 2 after its last (checkpoint_pinn).
  last = {tag: max([-1] + [h['step'] for h in hs
                           if 'preempt_ckpt' in h['events']])
          for tag, hs in phases.items()}
  want_resumed = ([('prelim', s) for s in range(last['prelim'] + 1, 3)]
                  + [('pinn', s) for s in range(last['pinn'] + 1,
                                                pinn_steps + 5)])
  if resumed_steps != want_resumed or resumed_final != pinn_steps + 5:
    failures.append(f'phase 2: resumed {resumed_steps}, final '
                    f'{resumed_final}; expected {want_resumed}')
  return report, launches, failures


def reset_counts():
  """Every kernel's launch counts to 0."""
  for kernel in (k1.conv3x3, k2.groupnorm_act, k3.correlation,
                 k3.correlation_df1, k3.correlation_df2, k4.ns_step_fused):
    kernel.launches = 0
  for counts in (k1.conv3x3.launches_by_kernel, k1.conv3x3.launches_by_use,
                 k4.ns_step_fused.launches_by_kernel):
    for key in counts:
      counts[key] = 0
  k3.correlation.batches.clear()
  for kernel in (k3.correlation, k3.correlation_df1, k3.correlation_df2):
    kernel.sizes.clear()


def profiled(name, fn):
  """``fn()`` under ``torch.profiler``: host seconds (the device
  synchronised at the end), device-busy seconds (the sum of the device ops'
  own times; one stream, so they do not overlap), the idle share, the
  number of device kernels and copies, and the top ones.  Returns (the
  summary, what ``fn`` returned)."""
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - start
  # The device's own events (kernels, copies), not the host ops that
  # launched them, whose device times would count each kernel twice.
  device_ops = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
  busy_s = sum(e.self_device_time_total for e in device_ops) * 1e-6
  top = sorted(device_ops, key=lambda e: -e.self_device_time_total)[:6]
  host_ops = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CPU),
                    key=lambda e: -e.self_cpu_time_total)[:6]
  # No device op in the trace means the profiler saw no device time, not
  # an idle device: the share is then not measured.
  families = collections.defaultdict(lambda: [0, 0.0])
  for e in device_ops:
    family = next((f for f, keys in DEVICE_FAMILIES
                   if any(k in e.key for k in keys)), 'other')
    families[family][0] += e.count
    families[family][1] += e.self_device_time_total * 1e-3
  out = dict(host_s=host_s, device_busy_s=busy_s,
             idle_share=1 - busy_s / host_s if device_ops else None,
             device_ops=sum(e.count for e in device_ops),
             families={f: tuple(v) for f, v in sorted(
                 families.items(), key=lambda kv: -kv[1][1])},
             top=[(e.key, e.count, e.self_device_time_total * 1e-3)
                  for e in top],
             top_host=[(e.key, e.count, e.self_cpu_time_total * 1e-3)
                       for e in host_ops])
  share = out['idle_share']
  log(f'  {name}: host {host_s:.4f} s, device busy {busy_s:.4f} s '
      f'(idle share {"not measured" if share is None else f"{share:.3f}"}'
      f'), {out["device_ops"]} device kernels and copies')
  log('    device ms by family (launches): ' + ', '.join(
      f'{f} {ms:.3f} ({n})' for f, (n, ms) in out['families'].items()))
  for key, count, ms in out['top']:
    log(f'    {ms:9.3f} ms  x{count:<5d} {key[:90]}')
  log('    host ops by own CPU time:')
  for key, count, ms in out['top_host']:
    log(f'    {ms:9.3f} ms  x{count:<5d} {key[:90]}')
  return out, result


def sampler_profile_phase(config, model, seed):
  """One steady step of the PC sampler (after a warm one), as
  ``core/sampling.py`` runs it: the corrector, then the predictor, each
  calling the score net at batch 8 in bf16."""
  sde, _ = sde_lib.get_sde(config)
  score_fn = registry.get_score_fn(sde, model, train=False,
                                   continuous=config.training.continuous)
  predictor = sampling.get_predictor(config.sampling.predictor.lower())
  corrector = sampling.get_corrector(config.sampling.corrector.lower())
  g = torch.Generator(device='cuda').manual_seed(seed)
  size, ch = config.data.image_size, config.data.num_channels
  shape = (BATCH, size, size, ch)

  def draw():
    return torch.randn(shape, generator=g, device='cuda')

  def step(x, t):
    vec_t = torch.full((BATCH,), t, device='cuda')
    x, _ = corrector(x, vec_t, sde, score_fn, config.sampling.snr,
                     config.sampling.n_steps_each, draw)
    x, _ = predictor(x, vec_t, sde, score_fn,
                     config.sampling.probability_flow, draw)
    return x

  with torch.inference_mode():
    x = step(draw(), 0.5)                                # the warm step
    out, _ = profiled('sampler step', lambda: step(x, 0.4))
  return out


@torch.no_grad()
def sequential_measure(kf, x, y, t, f, generator):
  """``PINN_KF.measure`` with its draws run one ``functional_call`` after
  another (8 FlowNet forwards, 40 cost volumes at batch 1), the structure
  the port had before it vmapped them: the yardstick of the vmapped
  measurement.  Draws come from ``generator`` in the same order."""
  size = (kf.ukf.size, kf.ukf.size)
  flows, press = [], []
  for _ in range(ukf_lib.N_DRAWS):
    params = bayes.sample_params(generator, kf.bparams)
    flow, pres = functional_call(kf.model, params, (kf.f_prev, f, x, y, t),
                                 {'size': size}, strict=True)
    flows.append(flow[-1])
    press.append(pres)
  flows, press = torch.stack(flows), torch.stack(press)
  return (flows.mean(0), flows.std(0, correction=0), press.mean(0),
          press.std(0, correction=0))


def ukf_profile_phase(seed):
  """One steady ukf cycle (after a warm one): the measurement with the
  draws vmapped and one after another (the same draws: the generator
  reseeded for each), compared and timed in turns on the host's clock,
  then each under ``torch.profiler``, and the filter likewise (see
  ``profiled``).  Returns (report, failures)."""
  config = configs.get_config(UKF_CONFIG)
  size = config.data.image_size
  data = ns_rollout(3, size, size, config.seed, device='cuda')
  model, params = init_pinn(config, seed=0, device='cuda')
  kf = ukf_lib.PINN_KF(config, model, bayes.make_bpinn_params(
      params, config, pretrained=False))

  def prep(channel, idx):
    return data[idx, channel][None, :, :, None]

  def gen():
    return torch.Generator(device='cuda').manual_seed(seed)

  kf.initialize(prep(2, 0), torch.cat([prep(3, 0), prep(4, 0)], dim=-1),
                prep(5, 0))
  t = torch.ones((1,), device='cuda')
  inputs = (prep(0, 2), prep(1, 2), t, prep(2, 2))
  ways = {'vmapped': lambda: kf.measure(*inputs, generator=gen()),
          'sequential': lambda: sequential_measure(kf, *inputs, gen())}
  kf.filter(prep(2, 1), kf.measure(prep(0, 1), prep(1, 1), t, prep(2, 1),
                                   gen()))                # the warm cycle
  out, failures = {}, []
  results = {way: fn() for way, fn in ways.items()}       # warm both
  errs = [rel_err(a, b) for a, b in zip(results['vmapped'],
                                        results['sequential'])]
  out['vmapped_vs_sequential_rel_err'] = [e[1] for e in errs]
  log(f'  measurement, vmapped vs sequential (same draws), rel error of '
      f'flow mean, flow std, pressure mean, pressure std: '
      f'{[f"{e[1]:.2e}" for e in errs]}')
  if not max(errs[0][1], errs[2][1]) <= TOL[torch.float32]:
    failures.append(f'measurement: vmapped and sequential means differ '
                    f'by {errs[0][1]:.3e}, {errs[2][1]:.3e}')
  host = {way: [] for way in ways}
  for _ in range(3):                                      # in turns
    for way in ('vmapped', 'sequential', 'sequential', 'vmapped'):
      torch.cuda.synchronize()
      start = time.perf_counter()
      ways[way]()
      torch.cuda.synchronize()
      host[way].append(time.perf_counter() - start)
  for way in ways:
    out[f'measurement_{way}_s'] = float(np.mean(host[way]))
  log(f'  measurement seconds (host clock, mean of 6 each): vmapped '
      f'{out["measurement_vmapped_s"]:.4f}, sequential '
      f'{out["measurement_sequential_s"]:.4f}')
  measurement = None
  for way in ways:
    out[f'measurement_{way}'], measurement = profiled(
        f'measurement ({way} draws)', ways[way])
  out['filter'], _ = profiled('filter', lambda: kf.filter(prep(2, 2),
                                                          measurement))
  return out, failures


def forward_phase(seed):
  """Full-width forward, every parameter randomised: kernels vs plain."""
  out, failures = {}, []
  for dtype in (torch.float32, torch.bfloat16):
    config, kernel_model = flagship(dtype, True, seed)
    _, plain_model = flagship(dtype, False, seed)
    x, labels = model_inputs(config, seed)
    with torch.inference_mode():
      got = kernel_model(x, labels, train=False)
      want = plain_model(x, labels, train=False)
      torch.cuda.synchronize()
      abs_err, rel = rel_err(got, want)
      finite = bool(torch.isfinite(got).all())
      ms = {}
      for path, net in (('kernel', kernel_model), ('plain', plain_model)):
        ms[path] = time_ms(lambda: net(x, labels, train=False), 5, 1)
        ms[path + '_device'] = device_ms(lambda: net(x, labels, train=False),
                                         3, 1)
    name = str(dtype).split('.')[-1]
    out[name] = dict(max_abs_err=abs_err, rel_err=rel, tol=TOL[dtype],
                     max_abs_out=float(want.abs().max()),
                     kernel_forward_ms=ms['kernel'],
                     plain_forward_ms=ms['plain'],
                     kernel_forward_device_ms=ms['kernel_device'],
                     plain_forward_device_ms=ms['plain_device'])
    log(f'  forward {name}: abs {abs_err:.3e} rel {rel:.3e} '
        f'(limit {TOL[dtype]}), max|y| {out[name]["max_abs_out"]:.3e}, '
        f'forward ms kernel path {ms["kernel"]:.2f} (device '
        f'{ms["kernel_device"]:.2f}) plain path {ms["plain"]:.2f} (device '
        f'{ms["plain_device"]:.2f})')
    if not (finite and rel <= TOL[dtype]):
      failures.append(f'forward {name}: rel {rel:.3e}, finite {finite}')
    del kernel_model, plain_model
  return out, failures


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--steps', type=int, default=None,
                      help='sampler steps N (default: the config, 1000)')
  parser.add_argument('--requests', type=int, default=2)
  parser.add_argument('--cycles', type=int, default=10,
                      help='ukf filter cycles (default 10, as ukf_lib.run)')
  parser.add_argument('--train-steps', type=int, default=40,
                      help='train steps after step 0 (default 40; even)')
  parser.add_argument('--prelim-steps', type=int, default=40,
                      help='PINN prelim steps after step 0 (default 40; '
                      'even)')
  parser.add_argument('--pinn-steps', type=int, default=20,
                      help='PINN phase-2 steps after its first (default '
                      '20; even)')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--out', default=None,
                      help='directory for chip_smoke.json (per-shape details)')
  args = parser.parse_args()

  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script runs on the card only',
          file=sys.stderr)
    return 2
  t_start = time.time()
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  log('f32 references: torch.backends.cudnn.allow_tf32 = False, '
      'torch.backends.cuda.matmul.allow_tf32 = False')
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60).stdout.strip()
  log(card.splitlines()[0])
  report = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda)
  failures = []

  log('[build]')
  t = time.time()
  ptxas = _build.build_all()
  report['build_s'] = time.time() - t
  log(f'  built {sorted(ptxas)} in {report["build_s"]:.1f} s')
  report['spill_bytes'] = {}
  for name, text in ptxas.items():
    spills = 0
    for line in text.splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'  {name}: {line.strip()}')
      if 'spill stores' in line:
        spills = max(spills, int(line.split('bytes spill stores')[0]
                                 .split(',')[-1]))
    report['spill_bytes'][name] = spills
  log(f'  most spill-store bytes of any kernel, by source: '
      f'{report["spill_bytes"]}')
  report['hgmma'] = hgmma_count()
  log(f'  HGMMA instructions in conv3x3_wgmma SASS: '
      f'{"SASS not inspected (no cuobjdump)" if report["hgmma"] is None else report["hgmma"]}')
  if report['hgmma'] == 0:
    failures.append('conv3x3_wgmma: no HGMMA instruction in its SASS')

  log('[kernels vs plain, main-path shapes]')
  _, model = flagship(torch.bfloat16, True, args.seed)
  config = model.config
  conv_sites, norm_sites = site_shapes(model, config, args.seed)
  per_forward = {'conv3x3': sum(conv_sites.values()),
                 'groupnorm_act': sum(norm_sites.values())}
  log(f'  sites per forward: {per_forward}')
  conv_rows, conv_total, conv_more, f1 = kernel_phase(
      'conv3x3', conv_sites, check_conv, args.seed)
  norm_rows, norm_total, norm_more, f2 = kernel_phase(
      'groupnorm_act', norm_sites, check_norm, args.seed)
  failures += f1 + f2
  report['kernels'] = {'conv3x3': conv_rows, 'groupnorm_act': norm_rows}
  report['per_forward_bf16'] = {
      'conv3x3': dict(conv_total, **conv_more),
      'groupnorm_act': dict(norm_total, **norm_more)}

  log('[K3, K4 vs plain, ukf-path shapes, f32]')
  flow_rows, flow_totals, f4 = flow_kernel_phase(args.seed)
  failures += f4
  report['kernels']['flow'] = flow_rows

  log('[full-width forward, kernel path vs plain path]')
  report['forward'], f3 = forward_phase(args.seed)
  failures += f3

  steps = args.steps or config.model.num_scales
  config.model.num_scales = steps
  cut = '' if steps == 1000 else ' (cut from 1000)'
  log(f'[serve: {args.requests} requests, batch {BATCH}, N={steps}, '
      f'bf16{cut}]')
  reset_counts()
  requests = []
  for r in range(args.requests):
    torch.cuda.synchronize()
    t = time.time()
    samples, nfe = run_lib.sample(config, batch_size=BATCH,
                                  seed=args.seed + r, device='cuda',
                                  model=model)
    torch.cuda.synchronize()
    seconds = time.time() - t
    finite = bool(torch.isfinite(samples).all())
    requests.append(dict(seconds=seconds, imgs_per_s=BATCH / seconds,
                         nfe=nfe, finite=finite, shape=list(samples.shape),
                         min=float(samples.min()), max=float(samples.max())))
    log(f'  request {r}: {seconds:.2f} s, {BATCH / seconds:.3f} imgs/s, '
        f'nfe {nfe}, finite {finite}, range [{requests[-1]["min"]:.3f}, '
        f'{requests[-1]["max"]:.3f}]')
    size, ch = config.data.image_size, config.data.num_channels
    if not finite or tuple(samples.shape) != (BATCH, size, size, ch):
      failures.append(f'request {r}: finite {finite}, shape '
                      f'{tuple(samples.shape)}')
  launches = {'conv3x3': k1.conv3x3.launches,
              'groupnorm_act': k2.groupnorm_act.launches}
  by_kernel = dict(k1.conv3x3.launches_by_kernel)
  log(f'  launches: {launches}, conv3x3 by kernel {by_kernel} (per forward '
      f'{per_forward}, x {steps} steps x {args.requests} requests)')
  for name, n in launches.items():
    if n == 0 or n != per_forward[name] * steps * args.requests:
      failures.append(f'{name}: {n} launches, expected '
                      f'{per_forward[name] * steps * args.requests}')
  if by_kernel['wgmma'] != launches['conv3x3'] or by_kernel['direct']:
    failures.append(f'conv3x3: bf16 sites left the wgmma kernel: {by_kernel}')
  report.update(requests=requests, launches=launches, steps=steps,
                per_forward=per_forward, conv3x3_by_kernel=by_kernel)
  log('[serve: one steady sampler step under torch.profiler]')
  report['sampler_profile'] = sampler_profile_phase(config, model, args.seed)

  train_batch = config.training.batch_size
  log(f'[train: one step\'s loss and gradients, kernel path vs plain path, '
      f'batch {train_batch}, f32 and bf16]')
  report['train_grads'], f7 = train_grad_phase(args.seed)
  failures += f7
  log(f'[train: K1 as the data gradient at the train step\'s sites, batch '
      f'{train_batch}]')
  dgrad_rows, dgrad_total, f8 = dgrad_phase(conv_sites, train_batch,
                                            args.seed)
  failures += f8
  report['kernels']['conv3x3_data_grad'] = dgrad_rows
  report['per_train_step_bf16'] = {'conv3x3_data_grad': dgrad_total}
  log(f'[train: run_lib.train, {CONFIG}, batch {train_batch}, bf16, steps '
      f'0..{args.train_steps}, snapshot sampling at N={steps}; then a '
      f'resume]')
  report['train'], train_launches, f9 = train_phase(
      steps, args.train_steps, per_forward, args.seed)
  failures += f9

  config = configs.get_config(UKF_CONFIG)
  log(f'[ukf: {UKF_CONFIG}, {config.data.image_size}x'
      f'{config.data.image_size}, feature_nums {config.model.feature_nums}, '
      f'patch {config.kf.patch_size}, {args.cycles} cycles, '
      f'{ukf_lib.N_DRAWS} draws a cycle, f32]')
  report['ukf'], ukf_launches, f5 = ukf_phase(args.cycles, args.out)
  failures += f5
  log('[ukf: one steady cycle, the measurement vmapped and sequential]')
  report['ukf_profile'], f6 = ukf_profile_phase(args.seed)
  failures += f6

  config = configs.get_config(PRELIM_CONFIG)
  prelim_batch_size = config.training.batch_size
  log(f'[PINN prelim: K3 backward vs plain at the {PRELIM_CONFIG} levels, '
      f'batch {prelim_batch_size}, f32]')
  bwd_rows, bwd_total, f10 = corr_bwd_phase(args.seed)
  failures += f10
  report['kernels']['correlation_bwd'] = bwd_rows
  report['per_prelim_step'] = {'correlation_bwd': bwd_total}
  log(f'[PINN prelim: one step\'s loss and gradients, kernel path vs plain '
      f'path, {config.data.image_size}x{config.data.image_size}, '
      f'feature_nums {config.model.feature_nums}, batch {prelim_batch_size}, '
      'f32]')
  report['prelim_grads'], f11 = prelim_grad_phase(args.seed)
  failures += f11
  log(f'[PINN prelim: pinn_lib.train_prelim, steps 0..{args.prelim_steps}; '
      'then a resume]')
  report['prelim'], prelim_launches, f12 = prelim_phase(args.prelim_steps,
                                                        args.seed)
  failures += f12

  log(f'[PINN phase 2: K3, B1 and B2 at third order vs plain at the '
      f'{PINN_CONFIG} levels, batch {prelim_batch_size}, f32]')
  report['kernels']['correlation_third_order'], f13 = corr_third_phase(
      args.seed)
  failures += f13
  log(f'[PINN phase 2: one step\'s residual, losses and gradients, kernel '
      f'path vs plain path, batch {prelim_batch_size}, f32]')
  report['pinn_grads'], f14 = pinn_grad_phase(args.seed)
  failures += f14
  log(f'[PINN phase 2: pinn_lib.train, phase 1 steps 0..2, phase 2 steps '
      f'2..{2 + args.pinn_steps}; then a resume]')
  report['pinn'], pinn_launches, f15 = pinn_phase(
      args.pinn_steps, report['pinn_grads']['step_launches'],
      report['pinn_grads']['eval_launches'], args.seed)
  failures += f15
  step_launches = report['pinn_grads']['step_launches']

  def entry(name, source, replaces, launches, total, yardstick=False):
    """One kernel's row of the table; a yardstick's numbers are its
    ``prev_*`` ones from the same rows, its launches those of the main
    path (none)."""
    row = dict(name=name, route='cuda',
               source=f'b_pinn_kalman_filter_tpu_torch/csrc/{source}',
               replaces=f'b_pinn_kalman_filter_tpu/ops/{replaces}',
               launches=launches)
    row.update({k: total[k] for k in ('max_abs_err', 'ms', 'plain_ms',
                                      'bound_ms', 'bound_by', 'library_ms')})
    if yardstick:
      row.update(max_abs_err=total['prev_abs_err'], ms=total['prev_ms'])
    return row

  conv_all = dict(conv_total, **conv_more)
  norm_all = dict(norm_total, **norm_more)
  corr, ns = flow_totals['correlation'], flow_totals['ns_step_fused']
  table = {'kernels': [
      entry('conv3x3', 'conv3x3_wgmma.cu', 'winograd_pallas.py:159',
            by_kernel['wgmma'], conv_all),
      entry('conv3x3_direct', 'conv3x3.cu', 'winograd_pallas.py:159',
            by_kernel['direct'], conv_all, yardstick=True),
      entry('conv3x3_data_grad', 'conv3x3_wgmma.cu', 'winograd_pallas.py:159',
            report['train']['conv3x3_by_use']['data_grad'], dgrad_total),
      entry('groupnorm_act', 'groupnorm.cu', 'groupnorm_pallas.py:118',
            launches['groupnorm_act'], norm_all),
      entry('groupnorm_act_pergroup', 'groupnorm_pergroup.cu',
            'groupnorm_pallas.py:118', 0, norm_all, yardstick=True),
      dict(entry('correlation', 'correlation.cu', 'correlation_pallas.py:42',
                 ukf_launches['correlation'], corr),
           phase2_launches=pinn_launches['correlation'],
           phase2_step_launches=step_launches['correlation'],
           phase2_step_device_ms=report['pinn']['k3_device_ms']),
      dict(entry('correlation_bwd', 'correlation_bwd.cu',
                 'correlation_pallas.py:42',
                 prelim_launches['correlation_df1']
                 + prelim_launches['correlation_df2'], bwd_total),
           phase2_launches=pinn_launches['correlation_df1']
           + pinn_launches['correlation_df2'],
           phase2_step_launches=step_launches['correlation_df1']
           + step_launches['correlation_df2'],
           phase2_step_device_ms=report['pinn']['k3_bwd_device_ms']),
      entry('correlation_tile', 'correlation_tile.cu',
            'correlation_pallas.py:42', 0, corr, yardstick=True),
      entry('ns_step_fused', 'ns_step.cu', 'ns_step_pallas.py:63',
            report['ukf']['ns_step_launches_by_kernel']['smem'], ns),
      entry('ns_step_staged', 'ns_step_staged.cu', 'ns_step_pallas.py:63',
            report['ukf']['ns_step_launches_by_kernel']['staged'], ns,
            yardstick=True),
  ]}
  report['table'] = table
  report['seconds'] = time.time() - t_start
  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'chip_smoke.json'), 'w') as f:
      json.dump(report, f, indent=1)
  log(f'total {report["seconds"]:.1f} s; kernel-table times (device ms): '
      'K1, K2 per U-Net forward (sum over the sites of one forward, bf16, '
      'batch 8), K1 as the data gradient per train step (bf16, batch '
      f'{train_batch}), K3, K4 per ukf cycle (f32), K3 backward (B1 + B2) '
      f'per prelim step (f32, batch {prelim_batch_size}), each yardstick '
      '(the first card design) at the same shapes; launches from the sampler '
      '(K1, K2), the train run (K1 data gradient), the ukf run (K3, K4) and '
      'the prelim run (K3 backward); phase2_* keys: K3 and K3 backward '
      'launches over the phase-2 train run and a step, and their device ms '
      'in the profiled phase-2 step')
  if failures:
    for failure in failures:
      print(f'FAILED: {failure}', file=sys.stderr)
    return 1
  log(json.dumps(table))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  try:
    sys.exit(main())
  except Exception:
    traceback.print_exc()
    sys.exit(1)
