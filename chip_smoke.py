#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--steps N] [--requests R] [--cycles C]
                          [--train-steps T] [--prelim-steps P]
                          [--pinn-steps Q] [--bpinn-steps R]
                          [--fixed-steps F] [--lfn-pinn-steps Q2]
                          [--lfn-bpinn-steps R2] [--nc-train-steps T2]
                          [--ncsnpp-train-steps T3]
                          [--seed S] [--out DIR]

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
   ``torch.profiler`` (a trace is kept only if every kernel launch in it
   has its device record), and the kernel's time per call back to back
   with CUDA events (the host's time where it exceeds the kernel's).  In bf16
   the first port's kernels are timed beside the main path's (K1's
   direct kernel, K2's one block per group), through private entries the
   main path never calls; K1 is also summed per level of the U-Net;
4. hold K3 (cost volume) and K4 (NS step) against their plain versions in
   f32 at every shape the ``ukf`` path launches them with (the five FlowNet
   levels of ``pinn/pinn_pde`` with the 8 B-PINN draws folded into the
   batch; the 129 sigma points and the rollout's one image at 64x64) and at
   an odd shape, K3 also at batch 1, and time both as in phase 3 (K3 at the
   ukf's shapes only), each beside its first card design, the yardstick
   (K3: one block per image and 8x8 tile, csrc/correlation_tile.cu; K4:
   three staged launches, csrc/ns_step_staged.cu); K3 runs twice and must
   give the same bits (no single PyTorch call computes either function);
5. a full-width flagship forward with every parameter randomised: the
   kernel path against the plain path, in f32 and bf16, each timed on the
   host's clock and in device time;
6. serve ``--requests`` (default 1) sample requests through
   ``run_lib.sample`` (batch 8,
   N = ``--steps``, default the config's 1000, bf16) with the launch counts
   set to 0 before and read after; the counts must be the per-forward site
   counts times N times the requests, every K1 launch the wgmma kernel's,
   and the samples finite; then profile one steady sampler step
   (``torch.profiler``): host and device-busy seconds, idle share, top
   device ops;
7. the training step (``--train-steps``, default 10): one step's loss and
   gradients at the flagship's full width and batch 128, kernel path
   against plain path (the same randomised parameters, batch, t, z and
   dropout generator), in f32 (TF32 off) and bf16, each leaf's gradient
   within the limit; K1 as the data gradient (dy through the flipped
   kernel) at every site shape at batch 128, against its plain version
   in f32 and bf16 and timed in bf16 beside ``torch.nn.grad.conv2d_input``;
   then ``run_lib.train`` at batch 128 in bf16 for steps
   0..``--train-steps`` with the
   cadence cut so that log, eval, the preemption checkpoint and a snapshot
   (sampling at N = 100) fire, the launch counts set to 0 before
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
   host seconds, and the vmapped one under ``torch.profiler`` (host and
   device-busy seconds, idle share, device ops, top ops), and the filter
   profiled likewise;
9. PINN phase 1 (``pinn/pinn_pde`` at full width: batch 64, 64x64,
   FlowNet levels 16..128, f32, TF32 off): K3's backward (B1 and B2,
   csrc/correlation_bwd.cu) against its plain versions at the five level
   shapes at batch 64 and at batch 8 and at odd shapes (C = 1 and 3, 5x7
   and 5x9), beside its first card design (csrc/correlation_bwd_tile.cu,
   the yardstick), each run twice for its bits, and
   one second-order product against autograd of the plain cost volume,
   timed as in phase 3 at the batch-64 shapes; one prelim step's loss and
   gradients, kernel
   path against plain path (the same randomised parameters, batch, mask
   and noise), every leaf within the limit of the largest leaf's
   gradient; then ``pinn_lib.train_prelim`` on the synthetic PDE data
   (rolled out by K4 at 200x128 into an empty data directory) for steps
   0..``--prelim-steps`` (default 10) with the cadence cut so that log,
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
   2..2 + ``--pinn-steps`` (default 4) with the cadence cut so that log,
   eval, the ``checkpoint_pinn`` preemption checkpoint and a snapshot fire
   in phase 2, the launch counts set to 0 before and read after (against
   the step's and the eval's counts); checks: finite losses, every leaf
   moved in phase 2, phase 2's Adam counts fresh, the step numbers; the
   steady phase-2 step's seconds and samples/s, peak memory, one steady
   step under ``torch.profiler`` (K3's and its backward's device ms), then
   a resume (phase 1 after its last preemption checkpoint, phase 2 from
   ``checkpoint_pinn``);
11. B-PINN training and the pipeline (the same width): one B-PINN loss on
   a MOPED posterior around a randomised PINN, kernel path against plain
   path (the same batch, mask, noises and draw): the flow and pressure
   MSEs and the two KL terms each within the limit of itself, the
   gradients in mu and rho of the data MSEs alone and of the whole loss,
   every leaf within the limit of the largest leaf's, and K3, B1, B2 5, 5,
   5 launches a train step and K3 5 an eval step; then, on a rollout made
   anew in an empty data directory, ``pinn_lib.train`` (phase 1 for steps
   0..2, phase 2 for 2..4) and ``train_bpinn`` from its last snapshot:
   first its step 0 alone (at lr 0: mu must equal the snapshot's
   ``ema_params`` bit for bit, rho ``inv_softplus(delta |w|)``), then
   steps 0..``--bpinn-steps`` (default 6) with log, eval, the preemption
   checkpoint and a snapshot firing, the launch counts set to 0 before and
   read after; checks: finite losses, every mu and rho leaf moved, both
   groups' Adam counts, the steady step's seconds and samples/s, the
   batch's assembly, peak memory, one steady step under
   ``torch.profiler``, a resume; ``ukf_lib.run`` from the B-PINN snapshot
   for 3 cycles (its posterior the snapshot's ``ema_params``, the belief,
   ``ukf.png``); ``simulator.run`` for 100 steps at 64x64 (K4 at batch 1)
   with the kernel rollout against the plain one, and ``simulate`` for 10
   frames under the bootstrapped mu; and the command line, ``python -m
   b_pinn_kalman_filter_tpu_torch --mode ukf --ckptdir <the B-PINN
   snapshot>`` in a subprocess;
12. the LiteFlowNet-PINN (``pinn/pinn_pde_lfn`` at full width: batch 64,
   64x64, f32): K3 at its three stride-1 levels (6, 5, 4: 2x2x192,
   4x4x128, 8x8x96) at batch 64 and 8, and B1 and
   B2 at batch 64 with the second-order product, against their plain
   versions and timed as in phase 3; one forward of the cascade, kernel
   path against plain path (every flow, 3 K3 launches, one a level); one
   prelim loss's gradients kernel path against plain path (3 K3, 3 B1, 3
   B2 launches); three steady prelim steps timed (seconds, samples/s,
   peak memory); one phase-2 loss kernel path against plain path (its
   launches by level; the LiteFlowNet reads no x, y, t, so the residual
   reaches the cost volumes at first order only); ``pinn_lib.train``
   (phase 1 for steps 0..2, phase 2 for 2..2 + ``--lfn-pinn-steps``,
   default 4, profiled, a resume); the B-PINN pipeline as in phase 11
   (the gradient check, ``train_bpinn`` from a PINN snapshot for
   ``--lfn-bpinn-steps``, default 4, not profiled, the MOPED bootstrap
   bit for bit, ``ukf_lib.run`` from its snapshot for 3 cycles, ``--mode ukf
   --config pinn/pinn_pde_lfn`` in a subprocess; not the simulator);
13. the inverse suite at ``inverse/nc_ddpmpp_inpaint_dps``'s full width
   (the NC U-Net: nf 128, ch_mult (1,2,2,2), 4 res blocks, attention at
   16^2, 64x64x1, batch 16, every parameter randomised): the U-Net's K1
   and K2 sites from one forward, K1, K1 as the data gradient and K2
   against their plain versions at each in f32 and bf16, timed as in
   phase 3 (K2's re-read branch, ``on_chip`` False, at 64x64 in f32 and
   at 256 and 384 channels in bf16); one DPS guided evaluation (the score
   and ``score_cond`` through the U-Net and back), kernel path against
   plain path, with its launches (79 K1, 79 K1 data gradients and 76 K2
   at full width); ``inverse_lib.inverse`` by the guided DPM-Solver++ (50
   steps) from a checkpoint of the random weights (seconds, NFE,
   launches, peak memory, the three files), the request again on the
   built model and one guided evaluation under ``torch.profiler``; the
   controlled sampler by RK45 (NFE, status, seconds); DPS by ``fixed`` at
   ``--fixed-steps`` (default 10 of the reference's 5000);
   ``run_lib.sample`` at the flagship by DPM-Solver (batch 8, 20 steps);
   and ``python -m b_pinn_kalman_filter_tpu_torch --mode inverse`` in a
   subprocess; and before those, ``run_lib.train`` at ``vp/nc_ddpmpp``
   (the same U-Net, batch 64, bf16) through the discrete DDPM loss for
   steps 0..``--nc-train-steps`` (default 4; no snapshot sampling), with
   its K1, K1 data-gradient and K2 launches a step, losses, step seconds
   and peak memory;
14. the flagship's ``eval`` and ``sample`` modes: K1's forward-mode term
   (K1 on the tangent) and the K2 JVP kernel (csrc/groupnorm_jvp.cu)
   against their plain versions at every flagship site (batch 8, f32 and
   bf16), timed in bf16 as in phase 3 beside ``torch.func.jvp`` of
   ``F.conv2d`` and of ``F.group_norm`` + ``F.silu`` and (K2 JVP) beside its
   first card design (csrc/groupnorm_jvp_cluster.cu, the yardstick); the
   K2 JVP kernel again at batch 256 (the bits/dim batch); one drift-plus-divergence
   evaluation of the likelihood (one forward-mode pass of the U-Net,
   every parameter randomised, batch 8), kernel path against plain path,
   with its launches (79 K1 on x and 79 on the tangent, 76 K2 and 76 K2
   JVP); ``run_lib.evaluate`` on phase 7's ``checkpoint_1`` with the
   loss, bits/dim and sampling on (cuts: ``eval.batch_size`` 256,
   ``bpd_dataset`` 'train', 128 samples at N = 100), the launch counts
   set to 0 before and read after, its files, FID/KID/IS and their
   feature source, one bpd evaluation at batch 256 under the profiler
   and timed in turns with the same by ``torch.func.jvp``, and 8 images'
   bpd kernel path against plain path in f32 (within 1e-3, the ODE at
   rtol = atol = 1e-3); then ``--mode sample --ckptdir`` (batch 8, N =
   100) and ``--mode eval`` (the loss) in subprocesses;
15. NCSN++ (``ve/cifar10_ncsnpp_continuous`` at full width: nf 128,
   ch_mult (1,2,2,2), 4 BigGAN resblocks a level with FIR [1,3,3,1]
   resampling, attention at 16^2, the residual input pyramid, Fourier
   features, ``scale_by_sigma``; 32x32x3, every parameter randomised):
   (a) K1 and K2 against their plain versions in bf16 at batch 8, timed as
   in phase 3 without yardsticks, at every site shape of it and of
   ``ve/church_ncsnpp_continuous`` (256^2, ch_mult (1,1,2,2,2,2,2), 2
   resblocks a level, output_skip and input_skip pyramids) that the
   flagship rows do not time, and at the church config's 128^2 and 256^2
   sites (256x256x128 and 256x256x256 the largest) forward and backward
   (K1's data gradient timed as in phase 7; K2's recomputed backward
   untimed) in f32 and bf16 at batch 8; (b) one full-width forward (batch
   8) and one train step's loss and gradients (batch 128) kernel path
   against plain path in f32 and bf16, with their launches (88 K1, 88 K1
   data gradients and 88 K2: 44 resblocks, two sites each; the first and
   last convs stay plain); (c) ``run_lib.train`` for steps
   0..``--ncsnpp-train-steps`` (default 4; no snapshot sampling) at batch
   128 in bf16 with its launches, one steady step profiled and the device
   ms of the FIR filters (``upfirdn2d``) one forward calls, measured alone
   with and without their backward, against the step's device-busy ms;
   one PC request (reverse diffusion + Langevin, snr 0.16) at batch 8
   with N cut to 100: NFE = 2 N, each evaluation 88 K1 and 88 K2 launches;
   (d) the church config at batch 8 (cut from 64): one forward kernel path
   against plain path in bf16 (98 K1, 98 K2) and ``run_lib.train`` for
   steps 0..1 on the LSUN stand-in;
16. print the kernel table as one JSON line (every kernel of the paths and
   every yardstick beside it; K3's and K3 backward's rows also carry their
   phase-2 and B-PINN launches, device ms and bounds a step, and their
   LiteFlowNet numbers (``lfn_*``); K1's, K1 data gradient's and K2's
   their DPS guided evaluation's and request's, their ``vp/nc_ddpmpp``
   train step's (``nc_train_*``) and their NCSN++ launches and new sites'
   times (``ncsnpp_*``, ``highres_*``); K1 JVP's and K2 JVP's launches
   over the evaluate run and an evaluation),
   then the ``{"ok": true, ...}`` line.  With ``--out DIR`` the per-shape
   details go to ``DIR/chip_smoke.json``.

Error limits (relative to max |reference|), in phases 3 to 5, 7 and 9 to 15:
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
from torch.profiler import ProfilerActivity, profile, schedule

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.core import likelihood, losses, sampling
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data.datasets import get_dataset
from b_pinn_kalman_filter_tpu_torch.data.scalers import (
    get_data_inverse_scaler, get_data_scaler)
from b_pinn_kalman_filter_tpu_torch.data.ns_rollout import ns_rollout
from b_pinn_kalman_filter_tpu_torch.inverse import conditional_sampling as cs
from b_pinn_kalman_filter_tpu_torch.inverse import (
    inverse_lib, obsv_sde, operators)
from b_pinn_kalman_filter_tpu_torch.kalman import simulator, ukf_lib
from b_pinn_kalman_filter_tpu_torch.models import layers, registry
from b_pinn_kalman_filter_tpu_torch.ops import _build
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from b_pinn_kalman_filter_tpu_torch.ops import ns_step as k4
from b_pinn_kalman_filter_tpu_torch.ops import resample
from b_pinn_kalman_filter_tpu_torch.ops import upfirdn2d as upfirdn2d_op
from b_pinn_kalman_filter_tpu_torch.pinn import bayes, pinn_lib
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn.pinn import (
    PINN, equation_mse, equation_mse_from_outputs)
from b_pinn_kalman_filter_tpu_torch.pinn.pinn_lib import init_pinn
from b_pinn_kalman_filter_tpu_torch.train import checkpoint as ckpt_lib
from b_pinn_kalman_filter_tpu_torch.train import run_lib
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from b_pinn_kalman_filter_tpu_torch.utils.misc import PNG_SIGNATURE

CONFIG = 'vp/cifar10_ddpmpp_continuous'
BATCH = 8
# The train phase's snapshot sampling: N = 100 (the serve phase runs the
# config's 1000).
SNAPSHOT_STEPS = 100
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
  """Print and flush; a phase's heading (``[...]``) gets the seconds since
  the script started."""
  if args and str(args[0]).startswith('['):
    args = args + (f'(t = {time.time() - T_START:.0f} s)',)
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


# A trace is complete when every kernel launch the host made in it has its
# device record (matched by correlation id).  torch.profiler can keep a
# launch call and lose its kernel's record: the first launches after it
# starts (one to a few, more late in a run), and records near the trace's
# edges (it keeps only those whose times, mapped onto the host's clock,
# fall inside its window, and that mapping drifts from the host's clock,
# by milliseconds after some minutes of a run).  So each trace runs ``fn``
# once in the profiler's warm-up step, whose records it drops, and
# measures a second call with idle host time at both ends of that step;
# the idle time grows fourfold, up to ``TRACE_MARGIN_MAX_S``, with each
# incomplete trace of the same call (scripts/profiler_drops_chip.py counts
# the drops with and without).
LAUNCH_CALLS = ('cudaLaunchKernel', 'cudaLaunchKernelExC',
                'cudaLaunchCooperativeKernel', 'cuLaunchKernel',
                'cuLaunchKernelEx')
TRACE_TRIES = 20
TRACE_MARGIN_S = 0.005
TRACE_MARGIN_MAX_S = 0.08
# Traces taken and traces dropped as incomplete over the run.
TRACES = collections.Counter()
# (seconds into the run, least lead in us) of every trace.
TRACE_LEADS = []
T_START = time.time()


def averages(prof):
  """``prof.key_averages()``, aggregated once a trace (a phase-2 step's
  trace holds some 300,000 events)."""
  if not hasattr(prof, 'bpkf_averages'):
    prof.bpkf_averages = prof.key_averages()
  return prof.bpkf_averages


def device_ops(prof):
  """The device's own records in a trace, summed by name (kernels,
  copies): not the host ops that launched them, whose device times would
  count each kernel twice, nor the profiler's step range, which it also
  draws on the device's timeline."""
  return [e for e in averages(prof) if e.device_type == DeviceType.CUDA
          and not e.key.startswith('ProfilerStep')]


def trace_complete(prof):
  """(True if every kernel launch in the trace has a device record, the
  launches, the device records, the least lead in us of a record's start
  over its launch call's start, or None); where the trace holds CUDA event
  records, only the launches between the first and the last count.  A
  kernel starts after its launch, so a negative lead is the drift of the
  device records' times against the host's clock."""
  events = prof.profiler.kineto_results.events()
  marks = [e.correlation_id() for e in events
           if e.name().startswith('cudaEventRecord')]
  lo, hi = (min(marks), max(marks)) if marks else (-1, float('inf'))
  on_device = {e.correlation_id(): e.start_ns() for e in events
               if e.device_type() == DeviceType.CUDA
               and not e.name().startswith('ProfilerStep')}
  launches = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != DeviceType.CUDA
              and e.name() in LAUNCH_CALLS and lo < e.correlation_id() < hi}
  leads = [on_device[c] - t for c, t in launches.items() if c in on_device]
  return (all(c in on_device for c in launches), len(launches),
          len(on_device), min(leads) * 1e-3 if leads else None)


def traced(fn, what):
  """``fn()`` under ``torch.profiler``, once in its warm-up step and once
  in its active step between two CUDA events, until the active step's
  trace is complete and its device-busy time is no more than the events'
  time; returns (the profile of the active step, host seconds, event ms,
  what the second call returned).  Raises after ``TRACE_TRIES``
  incomplete traces."""
  margin = TRACE_MARGIN_S
  for _ in range(TRACE_TRIES):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
      fn()
      torch.cuda.synchronize()
      prof.step()
      time.sleep(margin)
      t = time.perf_counter()
      start.record()
      result = fn()
      end.record()
      torch.cuda.synchronize()
      host_s = time.perf_counter() - t
      time.sleep(margin)
      prof.step()
    event_ms = start.elapsed_time(end)
    complete, n_launches, n_device, lead_us = trace_complete(prof)
    if lead_us is not None:
      TRACE_LEADS.append((round(time.time() - T_START, 1), lead_us))
    busy_ms = sum(e.self_device_time_total for e in device_ops(prof)) * 1e-3
    TRACES['taken'] += 1
    # CUPTI's and the events' clocks differ by far less than 1%.
    if complete and n_device and busy_ms <= 1.01 * event_ms:
      return prof, host_s, event_ms, result
    TRACES['incomplete'] += 1
    log(f'  (incomplete trace of {what}: {n_launches} launches, '
        f'{n_device} device records, busy {busy_ms:.4f} of {event_ms:.4f} '
        f'ms, margin {margin} s; taken again)')
    margin = min(4 * margin, TRACE_MARGIN_MAX_S)
  raise RuntimeError(f'torch.profiler gave no complete trace of {what} in '
                     f'{TRACE_TRIES} tries')


def device_ms(fn, iters=20, warmup=3):
  """Mean device ms of ``fn()``: the summed own times of the device ops
  (kernels, copies) that ``iters`` calls launch, from a complete
  ``torch.profiler`` trace, over ``iters``.  The host's time between
  launches is not in it."""
  for _ in range(warmup):
    fn()

  def calls():
    for _ in range(iters):
      fn()
  prof = traced(calls, f'{iters} calls')[0]
  busy_us = sum(e.self_device_time_total for e in device_ops(prof))
  return busy_us * 1e-3 / iters


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


# Randomised parameters by (config name, seed), kept on the host: the
# first model of a config is drawn by its init and ``randomize_`` (seconds
# of host RNG at full width), the later ones copy the same values.
RANDOMIZED = {}


def randomized_model(name, dtype, kernels, seed):
  """(config, model): ``name``'s config in ``dtype`` and its model on the
  card, every parameter randomised by ``randomize_`` from ``seed``."""
  config = configs.get_config(name)
  config.tpu.compute_dtype = {torch.float32: 'float32',
                              torch.bfloat16: 'bfloat16'}[dtype]
  key = (name, seed)
  if key not in RANDOMIZED:
    model = registry.create_model(config, device='cuda', seed=seed,
                                  kernels=kernels)
    randomize_(model, seed)
    RANDOMIZED[key] = {n: p.detach().cpu() for n, p in
                       model.named_parameters()}
    return config, model
  model = registry.get_model(config.model.name)(config, kernels=kernels)
  model = model.to('cuda').eval()
  with torch.no_grad():
    for n, p in model.named_parameters():
      p.copy_(RANDOMIZED[key][n])
  return config, model


def flagship(dtype, kernels, seed):
  return randomized_model(CONFIG, dtype, kernels, seed)


def model_inputs(config, seed, batch=BATCH):
  g = torch.Generator(device='cuda').manual_seed(seed)
  size, ch = config.data.image_size, config.data.num_channels
  x = torch.randn((batch, size, size, ch), generator=g, device='cuda')
  labels = torch.rand((batch,), generator=g, device='cuda') * 999
  return x, labels


def site_shapes(model, config, seed, batch=BATCH):
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
      model(*model_inputs(config, seed, batch), train=False)
  finally:
    for h in handles:
      h.remove()
  return convs, norms


def check_conv(shape, dtype, seed, batch=BATCH, yardstick=True):
  """K1 at the site (H, W, Cin, Cout) at ``batch`` against its plain
  version, timed beside cuDNN (and, with ``yardstick``, the first port's
  direct kernel where the main path takes the wgmma one)."""
  H, W, cin, cout = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  x = torch.randn((batch, H, W, cin), generator=g, device='cuda').to(dtype)
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
    prev = None if which == 'direct' or not yardstick else (
        lambda: k1._conv3x3_direct(x, w, b))
    row = dict(kernel=which, **timings(
        lambda: k1.conv3x3(x, w, b), lambda: k1.conv3x3_plain(x, w, b),
        lambda: F.conv2d(x_lib, w_lib, b_lib, padding=1), prev))
    if prev is not None:
      row['prev_abs_err'], row['prev_rel_err'] = rel_err(prev(), want)
  if which == 'wgmma':
    row['box'] = list(k1.wgmma_plan(batch, H, W, cin, cout)['box'])
  itemsize = x.element_size()
  flops = 2 * 9 * batch * H * W * cin * cout
  nbytes = (x.numel() + w.numel() + batch * H * W * cout) * itemsize + 4 * cout
  row['bound_ms'], row['bound_by'] = bound(flops, nbytes, dtype)
  row.update(max_abs_err=abs_err, rel_err=rel)
  return row


def check_norm(shape, dtype, seed, batch=BATCH, yardstick=True):
  """K2 at the site (H, W, C, G) at ``batch`` against its plain version,
  timed beside ``F.group_norm`` + ``F.silu`` (and, with ``yardstick``,
  the first port's kernel); ``on_chip`` is the plan's (False: the kernel
  reads x again for its later passes)."""
  H, W, C, G = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  x = (torch.randn((batch, H, W, C), generator=g, device='cuda') * 2 + 0.5
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
    prev = (lambda: k2._groupnorm_act_pergroup(x, scale, bias, G, 'silu')
            ) if yardstick else None
    row = timings(
        lambda: k2.groupnorm_act(x, scale, bias, G, 'silu'),
        lambda: k2.groupnorm_act_plain(x, scale, bias, G, 'silu'),
        lambda: F.silu(F.group_norm(x_lib, G, s_lib, b_lib, 1e-6)), prev)
    if prev is not None:
      row['prev_abs_err'], row['prev_rel_err'] = rel_err(prev(), want)
  row['on_chip'] = k2.groupnorm_plan(H, W, C, G, x.element_size())['on_chip']
  n = x.numel()
  nbytes = 2 * n * x.element_size() + 8 * C
  row['bound_ms'], row['bound_by'] = bound(10 * n, nbytes, dtype)
  row.update(max_abs_err=abs_err, rel_err=rel)
  return row


def kernel_phase(name, sites, check, seed,
                 dtypes=(torch.float32, torch.bfloat16), **kw):
  """Every site shape in each of ``dtypes`` (f32 and bf16; ``kw`` to
  ``check``: the batch, whether to time the yardstick); returns (rows,
  per-forward totals in bf16, more per-forward numbers, failures)."""
  rows, failures = [], []
  for i, (shape, count) in enumerate(sorted(sites.items())):
    for dtype in dtypes:
      row = check(shape, dtype, seed + i, **kw)
      row.update(shape=list(shape), dtype=str(dtype).split('.')[-1],
                 per_forward=count, tol=TOL[dtype])
      rows.append(row)
      prev = (f' first port {row["prev_ms"]:.4f} (rel '
              f'{row["prev_rel_err"]:.1e})' if 'prev_ms' in row else '')
      where = (f' box {row["box"]}' if 'box' in row else
               '' if 'on_chip' not in row else
               ' on chip' if row['on_chip'] else ' re-read')
      log(f'  {name} {shape} {row["dtype"]:8s} x{count:<2d} '
          f'{row.get("kernel", "")}{where} abs {row["max_abs_err"]:.3e} rel '
          f'{row["rel_err"]:.3e} | kernel {row["ms"]:.4f} ms (call '
          f'{row["call_ms"]:.4f}){prev} plain '
          f'{row["plain_ms"]:.4f} library {row["library_ms"]:.4f} bound '
          f'{row["bound_ms"]:.4f} ({row["bound_by"]})')
      for key in ('rel_err', 'prev_rel_err'):
        if key in row and not row[key] <= TOL[dtype]:
          failures.append(f'{name} {shape} {row["dtype"]}: {key} '
                          f'{row[key]:.3e} > {TOL[dtype]}')
      if not row.get('same_bits_twice', True):
        failures.append(f'{name} {shape} {row["dtype"]}: two runs differ')
  bf16 = [r for r in rows if r['dtype'] == 'bfloat16']
  total = {k: sum(r[k] * r['per_forward'] for r in bf16)
           for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
  prev_total = sum(r.get('prev_ms', 0.0) * r['per_forward'] for r in bf16)
  call_total = sum(r['call_ms'] * r['per_forward'] for r in bf16)
  timed_prev = any('prev_ms' in r for r in bf16)
  log(f'  {name} per forward (bf16, device ms): kernel {total["ms"]:.4f}, '
      + (f'first port {prev_total:.4f}, ' if timed_prev else '')
      + f'plain {total["plain_ms"]:.4f}, library '
      f'{total["library_ms"]:.4f}, bound {total["bound_ms"]:.4f}; kernel '
      f'calls back to back {call_total:.4f}')
  levels = {}
  for r in bf16:
    level = levels.setdefault(r['shape'][0], dict(
        sites=0, ms=0.0, prev_ms=0.0, library_ms=0.0, bound_ms=0.0))
    level['sites'] += r['per_forward']
    for k in ('ms', 'prev_ms', 'library_ms', 'bound_ms'):
      level[k] += r.get(k, 0.0) * r['per_forward']
  for h, level in sorted(levels.items(), reverse=True):
    log(f'    {h}x{h}: {level["sites"]} sites, kernel {level["ms"]:.4f} ms, '
        + (f'first port {level["prev_ms"]:.4f}, ' if timed_prev else '')
        + f'library {level["library_ms"]:.4f}, bound '
        f'{level["bound_ms"]:.4f}')
  by = collections.Counter()
  for r in bf16:
    by[r['bound_by']] += r['bound_ms'] * r['per_forward']
  total['bound_by'] = by.most_common(1)[0][0]
  total['max_abs_err'] = max(r['max_abs_err'] for r in bf16)
  prev_err = max(r.get('prev_abs_err', 0.0) for r in bf16)
  return rows, total, dict(prev_ms=prev_total, prev_abs_err=prev_err,
                           call_ms=call_total, levels=levels), failures


def corr_bound(shape):
  """K3's least time in ms at (B, H, W, C), f32, and what sets it: f1 and
  f2 read once, the 49-channel cost volume written once; 49 C
  multiply-adds a pixel."""
  B, H, W, C = shape
  pixels = B * H * W
  return bound(2 * 49 * C * pixels, 2 * pixels * C * 4 + 49 * pixels * 4,
               torch.float32)


def check_corr(shape, seed, yardstick=True, timed=True):
  """K3 against its plain version at (B, H, W, C), f32, with
  ``yardstick`` the tile kernel (its first card design) too; K3 run twice
  for its bits; with ``timed`` each timed, in turns."""
  B, H, W, C = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  f1 = torch.randn(shape, generator=g, device='cuda')
  f2 = torch.randn(shape, generator=g, device='cuda')
  with torch.inference_mode():
    got = k3.correlation(f1, f2)
    again = k3.correlation(f1, f2)
    want = k3.correlation_plain(f1, f2)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    row = {}
    if timed:
      row = timings(lambda: k3.correlation(f1, f2),
                    lambda: k3.correlation_plain(f1, f2),
                    prev=(lambda: k3._correlation_tile(f1, f2)) if yardstick
                    else None)
    if yardstick:
      row['prev_abs_err'], row['prev_rel_err'] = rel_err(
          k3._correlation_tile(f1, f2), want)
  row['same_bits_twice'] = bool(torch.equal(got, again))
  row['plan'] = k3.correlation_plan(*shape)
  row['bound_ms'], row['bound_by'] = corr_bound(shape)
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
  shapes (``prev_ms``).  K3 at batch 1 and at the odd shape is checked,
  not timed."""
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
      timed = name == 'ns_step_fused' or per_cycle > 0
      row = (check(shape, seed + i) if timed else
             check(shape, seed + i, timed=False))
      row.update(kernel=name, shape=list(shape), dtype='float32',
                 per_cycle=per_cycle, tol=TOL[torch.float32])
      mine.append(row)
      times = ''
      if timed:
        share = row['bound_ms'] / row['ms']
        times = (f' | kernel {row["ms"]:.4f} ms (call {row["call_ms"]:.4f}) '
                 f'yardstick {row["prev_ms"]:.4f} plain '
                 f'{row["plain_ms"]:.4f} bound {row["bound_ms"]:.6f} '
                 f'({row["bound_by"]}; '
                 + (f'{share:.3f} of the kernel time' if share <= 1 else
                    'kernel under the HBM bound: inputs from L2') + ')')
      log(f'  {name} {shape} x{per_cycle} abs {row["max_abs_err"]:.3e} '
          f'rel {row["rel_err"]:.3e} yardstick rel '
          f'{row["prev_rel_err"]:.1e}{times}'
          + (f' plan {row["plan"]}' if 'plan' in row else '')
          + ('' if row.get('same_bits_twice', True) else ' NOT BITWISE'))
      for key in ('rel_err', 'prev_rel_err'):
        if not row[key] <= TOL[torch.float32]:
          failures.append(f'{name} {shape}: {key} {row[key]:.3e}')
      if not row.get('same_bits_twice', True):
        failures.append(f'{name} {shape}: two runs differ')
    total = {k: sum(r[k] * r['per_cycle'] for r in mine if r['per_cycle'])
             for k in ('ms', 'plain_ms', 'bound_ms', 'prev_ms')}
    by = collections.Counter()
    for r in mine:
      if r['per_cycle']:
        by[r['bound_by']] += r['bound_ms'] * r['per_cycle']
    total.update(bound_by=by.most_common(1)[0][0], library_ms=None,
                 max_abs_err=max(r['max_abs_err'] for r in mine),
                 prev_abs_err=max(r['prev_abs_err'] for r in mine))
    totals[name] = total
    rows += mine
  c, k = totals['correlation'], totals['ns_step_fused']
  log(f'  per cycle (device ms): K3 {c["ms"]:.4f} in {len(levels)} launches '
      f'at batch {draws} vs tile kernel {c["prev_ms"]:.4f} at the same '
      f'shapes; bound {c["bound_ms"]:.6f}.  K4 {k["ms"]:.4f} vs staged '
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


def train_grad_phase(seed, build=None, bf16_tree=False):
  """One train step's loss and gradients, kernel path against plain path,
  at the full width and train batch of the flagship (or of the model
  ``build(dtype, kernels, seed)`` gives): the same randomised parameters,
  batch, t, z and dropout generator, in f32 (TF32 off) and bf16; each
  leaf's gradient within the limit of max |plain gradient| of that leaf
  (of the largest leaf, for a leaf that is zero but for rounding, or
  outside the graph: NCSN++'s Fourier ``W``), and the kernel path's
  launches in bf16 (``launches``).  With ``bf16_tree`` the bf16 gradients
  are held relative to the largest leaf's, as the CPU tests hold their
  trees, and reported leaf by leaf beside the plain path's own spread: the
  plain path again on the batch moved by 2^-9 of itself at random.
  Returns (report, failures)."""
  out, failures = {}, []
  build = build or flagship
  for dtype in (torch.float32, torch.bfloat16):
    config, kernel_model = build(dtype, True, seed)
    _, plain_model = build(dtype, False, seed)
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
      loss_fn = losses.get_sde_loss_fn(
          sde, model, True, reduce_mean=config.training.reduce_mean,
          likelihood_weighting=False)
      dropout = torch.Generator(device='cuda').manual_seed(seed + 1)
      reset_counts()
      loss = loss_fn(params, batch, dropout, noise=(t, z))
      grads = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True, materialize_grads=True)
      torch.cuda.synchronize()
      if path == 'kernel':
        step_launches = dict(k1.conv3x3.launches_by_use,
                             groupnorm_act=k2.groupnorm_act.launches)
      results[path] = (float(loss.detach()), dict(zip(params, grads)))
      del loss, grads
    if bf16_tree and dtype == torch.bfloat16:
      params = dict(plain_model.named_parameters())
      moved = batch * (1 + 2 ** -9 * torch.randn(
          batch.shape, generator=g, device='cuda').sign())
      loss = losses.get_sde_loss_fn(
          sde, plain_model, True, reduce_mean=config.training.reduce_mean,
          likelihood_weighting=False)(
              params, moved, torch.Generator(device='cuda').manual_seed(
                  seed + 1), noise=(t, z))
      spread = dict(zip(params, torch.autograd.grad(
          loss, list(params.values()), allow_unused=True,
          materialize_grads=True)))
      del loss
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
                     tol=TOL[dtype], launches=step_launches)
    gated = leaf_errs[worst[0]]
    if bf16_tree and dtype == torch.bfloat16:
      def tree(a, b):
        return max(float((a[n].float() - b[n].float()).abs().max())
                   for n in b) / top
      spread_errs = {n: float((spread[n].float() - p_grads[n].float())
                              .abs().max()) / (
                                  top if n in zero
                                  else float(p_grads[n].abs().max()))
                     for n in p_grads}
      out[name].update(
          tree_rel=tree(k_grads, p_grads),
          spread_tree_rel=tree(spread, p_grads),
          spread_max_leaf_rel=max(spread_errs.values()),
          spread_of_worst_leaves={n: spread_errs[n] for n in worst},
          worst_leaf_scale={n: float(p_grads[n].abs().max()) / top
                            for n in worst})
      gated = out[name]['tree_rel']
      log(f'  bf16 gradients relative to the largest leaf: kernel vs plain '
          f'{out[name]["tree_rel"]:.2e} (limit {TOL[dtype]}); the plain '
          f'path against itself on the batch moved by 2^-9: '
          f'{out[name]["spread_tree_rel"]:.2e}, leaf by leaf up to '
          f'{out[name]["spread_max_leaf_rel"]:.2e} (at the worst leaves '
          + ', '.join(f'{spread_errs[n]:.2e}' for n in worst)
          + '; their scale to the largest leaf '
          + ', '.join(f'{v:.2e}' for v in
                      out[name]['worst_leaf_scale'].values()) + ')')
      del spread
    log(f'  train-step gradients {name}, batch {batch_size}: loss kernel '
        f'{k_loss:.6f} plain {p_loss:.6f} (rel {loss_rel:.2e}); '
        f'{len(leaf_errs)} leaves ({len(zero)} zero but for rounding, '
        f'held relative to the largest: {zero[:3]}...), worst rel '
        + ', '.join(f'{n} {leaf_errs[n]:.2e}' for n in worst)
        + f' (limit {TOL[dtype]}); kernel-path launches {step_launches}')
    if not (finite and loss_rel <= TOL[dtype] and gated <= TOL[dtype]):
      failures.append(f'train-step gradients {name}: loss rel '
                      f'{loss_rel:.3e}, worst leaf {worst[0]} '
                      f'{leaf_errs[worst[0]]:.3e}, held {gated:.3e}, '
                      f'finite {finite}')
    del kernel_model, plain_model, results, k_grads, p_grads
    torch.cuda.empty_cache()
  return out, failures


def train_phase(steps, train_steps, per_forward, seed, workdir):
  """``run_lib.train`` at the flagship's full width, batch 128, bf16, for
  ``train_steps`` + 1 steps with the cadence cut so that log, eval, the
  preemption checkpoint and a snapshot (sampling at N = ``steps``) fire;
  the launch counts set to 0 before and read after; then a second call
  that resumes from the preemption checkpoint.  ``workdir`` keeps its
  checkpoints for the eval phase.  Returns (report, launches,
  failures)."""
  config = configs.get_config(CONFIG)
  config.model.num_scales = steps
  t = config.training
  t.n_iters = train_steps
  t.log_freq = 10
  t.eval_freq = train_steps // 2
  t.snapshot_freq_for_preemption = train_steps // 2
  t.snapshot_freq = train_steps
  failures, history = [], []
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
                  'data_grad': per_forward['conv3x3'] * n_steps, 'jvp': 0}
  sample = os.path.join(workdir, 'samples', f'iter_{train_steps}',
                        'sample.np')
  sample_shape = (list(np.load(sample).shape) if os.path.exists(sample)
                  else None)
  png = os.path.join(os.path.dirname(sample), 'sample.png')
  sample_png = (os.path.exists(png)
                and open(png, 'rb').read(8) == PNG_SIGNATURE)

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
      sample_png=sample_png,
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
      f'{leaf}: rel {ema_err:.2e}; samples {sample_shape} (PNG grid '
      f'{sample_png}); resumed at '
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
  if not sample_png:
    failures.append('train: no snapshot sample.png')
  if sample_shape != [t.batch_size // 4, size, size,
                      config.data.num_channels]:
    failures.append(f'train: snapshot samples {sample_shape}')
  want_resumed = list(range(train_steps + 1, train_steps + 5))
  if resumed_steps != want_resumed or resumed_final != train_steps + 5:
    failures.append(f'train: resumed steps {resumed_steps}, final '
                    f'{resumed_final}; expected {want_resumed}')
  return report, launches, failures


PRELIM_CONFIG = 'pinn/pinn_pde'


def check_corr_bwd(shape, seed, yardstick=True, timed=True):
  """K3's backward at (B, H, W, C), f32: B1 and B2 against their plain
  versions (each kernel twice for its bits), with ``yardstick`` the first
  card design too, with ``timed`` each timed in turns; one second-order
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
      times = {}
      if timed:
        times = timings(lambda: fn(d, a), lambda: plain(d, a),
                        prev=(lambda: k3._gradient_tile(name, d, a))
                        if yardstick else None)
      if yardstick:
        times['prev_abs_err'], times['prev_rel_err'] = rel_err(
            k3._gradient_tile(name, d, a), want)
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
  for k in ('ms', 'call_ms', 'plain_ms', 'prev_ms'):
    if k in row['df1']:
      row[k] = row['df1'][k] + row['df2'][k]
  row['bound_ms'] *= 2
  for k in ('max_abs_err', 'rel_err', 'prev_abs_err', 'prev_rel_err'):
    if k in row['df1']:
      row[k] = max(row['df1'][k], row['df2'][k])
  plan = k3.correlation_bwd_plan(*shape)
  row['plan'] = {k: plan[k] for k in ('th', 'tw', 'strip', 'split', 'cs',
                                      'threads', 'blocks', 'smem_bytes')}
  return row


def corr_bwd_phase(seed):
  """K3's backward at the prelim step's five level shapes at batch 64
  (one B1 and one B2 launch each a step), timed beside the first card
  design (8x8 tiles, the yardstick), and checked at the same levels at
  batch 8 and at odd shapes (C = 1 and 3, H and W not multiples of 8),
  the yardstick too, not timed.  Returns (rows, per-step totals,
  failures)."""
  config = configs.get_config(PRELIM_CONFIG)
  size, batch = config.data.image_size, config.training.batch_size
  levels = [(size >> (i + 1), c)
            for i, c in enumerate(config.model.feature_nums)]
  shapes = ([((batch, h, h, c), 1) for h, c in levels]
            + [((8, h, h, c), 0) for h, c in levels]
            + [((3, 13, 11, 24), 0), ((2, 5, 7, 3), 0), ((2, 5, 9, 1), 0)])
  rows, failures = [], []
  tol = TOL[torch.float32]
  for i, (shape, per_step) in enumerate(shapes):
    row = check_corr_bwd(shape, seed + i, timed=per_step > 0)
    row.update(shape=list(shape), per_step=per_step, tol=tol)
    rows.append(row)
    times = ('' if not per_step else
             f' | kernels {row["ms"]:.4f} ms (df1 {row["df1"]["ms"]:.4f}, '
             f'df2 {row["df2"]["ms"]:.4f}; calls {row["call_ms"]:.4f}) first '
             f'design {row["prev_ms"]:.4f} plain {row["plain_ms"]:.4f} bound '
             f'{row["bound_ms"]:.6f} ({row["bound_by"]})')
    log(f'  B1+B2 {shape} x{per_step} rel df1 {row["df1"]["rel_err"]:.3e} '
        f'df2 {row["df2"]["rel_err"]:.3e} second order '
        f'{row["second_order_rel_err"]:.3e}{times} plan {row["plan"]}')
    for key in ('df1', 'df2'):
      for err in ('rel_err', 'prev_rel_err'):
        if not row[key][err] <= tol:
          failures.append(f'correlation {key} {shape}: {err} '
                          f'{row[key][err]:.3e}')
      if not row[key]['same_bits_twice']:
        failures.append(f'correlation {key} {shape}: two runs differ')
    if not row['second_order_rel_err'] <= tol:
      failures.append(f'correlation second order {shape}: rel '
                      f'{row["second_order_rel_err"]:.3e}')
  total = {k: sum(r[k] * r['per_step'] for r in rows if r['per_step'])
           for k in ('ms', 'call_ms', 'plain_ms', 'bound_ms', 'prev_ms')}
  total.update(bound_by='bytes', library_ms=None,
               max_abs_err=max(r['max_abs_err'] for r in rows),
               prev_abs_err=max(r['prev_abs_err'] for r in rows))
  log(f'  per prelim step (f32, batch {batch}, device ms): B1+B2 kernels '
      f'{total["ms"]:.4f} in {2 * len(config.model.feature_nums)} launches, '
      f'first design {total["prev_ms"]:.4f}, plain {total["plain_ms"]:.4f}, '
      f'bound {total["bound_ms"]:.6f}')
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


def prelim_grad_phase(seed, name=None):
  """One prelim loss's gradients at full width of the config ``name``
  (default ``PRELIM_CONFIG``), kernel path (K3 and its backward) against
  plain path (the plain cost volume under autograd): the same randomised
  parameters, batch, mask and noise.  The loss within the limit of
  itself, every leaf within the limit of the largest leaf's gradient; the
  kernel path's K3, B1 and B2 launches a step, one of each a level on K3.
  Returns (report, failures)."""
  config = configs.get_config(name or PRELIM_CONFIG)
  models = {}
  for path, kernels in (('kernel', True), ('plain', False)):
    models[path] = PINN(config, kernels=kernels).cuda()
    randomize_(models[path], seed)
  batch, mask, noise = prelim_batch(config, seed)
  results = {}
  for path, model in models.items():
    params = dict(model.named_parameters())
    reset_counts()
    loss, v_loss, p_loss = pinn_losses.get_prelim_loss_fn(config, model)(
        params, mask, batch, noise=noise)
    grads = torch.autograd.grad(loss, list(params.values()))
    if path == 'kernel':
      step_launches = flow_counts()
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
  levels = k3_levels(config)
  want_step = {kernel: levels for kernel, _ in FLOW_KERNELS}
  out = dict(losses_kernel=k_losses, losses_plain=p_losses,
             loss_rel=loss_rel, max_leaf_rel=leaf_errs[worst[0]],
             worst_leaves={n: leaf_errs[n] for n in worst},
             worst_own_leaf=(worst_own, own_errs[worst_own]),
             leaves=len(leaf_errs), tol=tol, step_launches=step_launches)
  log(f'  prelim gradients f32, batch {config.training.batch_size}: (loss, '
      f'v, p) kernel {k_losses} plain {p_losses} (rel {loss_rel:.2e}); '
      f'{len(leaf_errs)} leaves, worst rel to the largest leaf '
      + ', '.join(f'{n} {leaf_errs[n]:.2e}' for n in worst)
      + f' (limit {tol}); worst rel to its own leaf {worst_own} '
      f'{own_errs[worst_own]:.2e}; kernel launches a step {step_launches} '
      f'(expected {want_step})')
  failures = []
  if not (finite and loss_rel <= tol and leaf_errs[worst[0]] <= tol):
    failures.append(f'prelim gradients: loss rel {loss_rel:.3e}, worst leaf '
                    f'{worst[0]} {leaf_errs[worst[0]]:.3e}, finite {finite}')
  if step_launches != want_step:
    failures.append(f'prelim gradients: launches {step_launches}, expected '
                    f'{want_step}')
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


def k3_levels(config):
  """The cost volumes a flow net's forward runs on K3: every FlowNet
  level; the LiteFlowNet's stride-1 levels 6, 5 and 4 (its levels 3 and
  2 take the stride-2 plain version, as the JAX dispatch does)."""
  if config.model.arch == 'liteflownet':
    return len(LFN_LEVELS)
  return len(config.model.feature_nums)


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


def pinn_grad_phase(seed, name=None):
  """One phase-2 loss at full width, kernel path (K3, B1, B2 to third
  order) against plain path (the plain cost volume under autograd): the
  same randomised parameters, batch, mask and noise.  Compares the
  residual and the data loss, the gradient of the residual alone (at the
  loss weight 1e-5 a wrong one would vanish in the total; leaves it does
  not reach are zeros) and the total gradient, every leaf within the
  limit of the largest leaf's gradient; counts the kernel path's launches
  by stage of the residual, by level, for one train step and for one eval
  step.  ``name``: the config (default ``PINN_CONFIG``).  A LiteFlowNet
  reads no x, y or t, so its residual does not differentiate the cost
  volumes: there the residual and its gradient are reported here and
  held by ``lfn_residual_phase``.  Returns (report, failures)."""
  config = configs.get_config(name or PINN_CONFIG)
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
  # (loss, pinn_loss, data_loss): the residual's parts held where the
  # residual reaches the cost volumes.
  held = (('residual', 'total') if config.model.arch == 'flownet'
          else ('total',))
  held_values = [v for i, v in enumerate(value_rel)
                 if i != 1 or 'residual' in held]
  out.update(values_kernel=k['values'], values_plain=p['values'],
             value_rel=value_rel, tol=tol, held=list(held))
  for which in ('residual', 'total'):
    worst, top3 = leaf_errors(k[which], p[which])
    finite = all(bool(torch.isfinite(v).all()) for v in k[which].values())
    out[f'{which}_grad'] = dict(max_leaf_rel=worst, worst_leaves=top3,
                                finite=finite, leaves=len(k[which]))
    log(f'  {which} gradient, kernel vs plain: worst leaf rel to the '
        'largest leaf ' + ', '.join(f'{n} {e:.2e}' for n, e in top3.items())
        + (f' (limit {tol})' if which in held else ' (reported)')
        + f', finite {finite}')
    if not finite or (which in held and worst > tol):
      failures.append(f'phase-2 {which} gradient: worst leaf {worst:.3e}, '
                      f'finite {finite}')
  log(f'  (loss, pinn_loss, data_loss) kernel {k["values"]} plain '
      f'{p["values"]} (rel {[f"{v:.2e}" for v in value_rel]})')
  if not max(held_values) <= tol:
    failures.append(f'phase-2 losses: rel {max(held_values):.3e}')
  log('  launches of the residual\'s gradient by stage (cumulative): '
      + '; '.join(f'{stage} {counts}' for stage, counts in out['stages']))
  log(f'  launches of one train step {out["step_launches"]}, by image size '
      f'{out["step_launches_by_size"]}; of one eval step '
      f'{out["eval_launches"]}')
  return out, failures


def pinn_phase(pinn_steps, per_step, per_eval, seed, name=None):
  """``pinn_lib.train`` at pinn_pde's full width: phase 1 for steps 0..2,
  phase 2 for steps 2..2 + ``pinn_steps`` with the cadence cut so that
  log, eval, the ``checkpoint_pinn`` preemption checkpoint and a snapshot
  fire in phase 2, on a rollout made anew in an empty data directory;
  the launch counts set to 0 before and read after, against the train
  and eval steps' counts of ``pinn_grad_phase`` (``per_step``,
  ``per_eval``); then a resume.  ``name``: the config (default
  ``PINN_CONFIG``).  Returns (report, launches, failures)."""
  config = configs.get_config(name or PINN_CONFIG)
  t = config.training
  t.n_iters = 2
  t.n_pinn_iters = pinn_steps
  t.log_freq = pinn_steps // 2
  t.eval_freq = pinn_steps // 2
  t.snapshot_freq_for_preemption = pinn_steps // 2
  t.snapshot_freq = pinn_steps
  levels = k3_levels(config)
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
      unmoved = [n for n, v in state.params.items()
                 if torch.equal(phase1_end['params'][n], v)]
      moved = len(state.params) - len(unmoved)
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
      # A leaf that did not move in phase 2 must have a gradient below
      # Adam's eps, where an update of about lr * |g| / eps rounds away
      # in f32 (the LiteFlowNet's coarsest level at its init: ~1e-17).
      unmoved_grad = {}
      if unmoved:
        loss = pinn_losses.get_pinn_loss_fn(config, model)(
            state.params, mask, batch, g)[0]
        unmoved_grad = {n: float(v.abs().max()) for n, v in zip(
            unmoved, torch.autograd.grad(
                loss, [state.params[n] for n in unmoved]))}
        del loss
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
      leaves=n_leaves, unmoved_grad=unmoved_grad, adam_counts=counts,
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
      f'parameters moved in phase 2 {moved} of {report["leaves"]} (the '
      f'others\' largest gradient '
      f'{max(unmoved_grad.values(), default=0.0):.2e}, Adam\'s eps '
      f'{config.optim.eps}); Adam counts {counts} after {n_pinn} phase-2 '
      f'steps; final step {final_step}; resumed {resumed_steps} to step '
      f'{resumed_final}')
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
  if any(v >= config.optim.eps for v in unmoved_grad.values()):
    failures.append(f'phase 2: {moved} of {report["leaves"]} leaves moved; '
                    f'the others\' gradients {unmoved_grad}')
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


BPINN_CONFIG = 'pinn/pinn_pde'


def moped_posterior(config, seed):
  """The flat MOPED posterior (``pinn/bayes.py``) around a PINN with every
  parameter randomised, so that no leaf is zero and no rho sits at
  ``inv_softplus(1e-12)``."""
  model = PINN(config).cuda()
  randomize_(model, seed)
  params = {key: {n: p.detach() for n, p in
                  getattr(model, key).named_parameters()}
            for key in ('flownet', 'pressurenet')}
  return bayes.flatten_posterior(bayes.make_bpinn_params(params, config,
                                                         pretrained=True))


def bpinn_grad_phase(seed, name=None):
  """One B-PINN loss at full width, kernel path (K3, B1, B2) against plain
  path (the plain cost volume under autograd): the same MOPED posterior,
  batch, mask, noises and draw.  Compares the four terms (the flow and
  pressure MSEs, the two KL terms) each against itself, and the
  gradients in mu and rho of the data MSEs alone (the KL terms, thousands
  of times larger and the same torch ops on both paths, would hide
  them) and of the whole loss, every leaf within the limit of the largest
  leaf's; counts the kernel path's K3, B1 and B2 launches for one train
  step and one eval step.  ``name``: the config (default
  ``BPINN_CONFIG``).  Returns (report, failures)."""
  config = configs.get_config(name or BPINN_CONFIG)
  batch, mask, noise = prelim_batch(config, seed)
  posterior = moped_posterior(config, seed)
  g = torch.Generator(device='cuda').manual_seed(seed + 2)
  eps = bayes.sample_eps(g, bayes.nest_posterior(posterior))
  out, results = {}, {}
  for path, kernels in (('kernel', True), ('plain', False)):
    model = PINN(config, kernels=kernels).cuda()
    params = {k: v.clone().requires_grad_() for k, v in posterior.items()}
    loss_fn = bayes.get_bpinn_loss_fn(config, model)
    reset_counts()
    loss, _, _, terms = loss_fn(params, mask, batch, noise=noise, eps=eps)
    g_all = torch.autograd.grad(loss, list(params.values()))
    step_counts = flow_counts()
    reset_counts()
    with torch.no_grad():
      loss_fn(params, mask, batch, noise=noise, eps=eps)
    eval_counts = flow_counts()
    _, _, _, terms = loss_fn(params, mask, batch, noise=noise, eps=eps)
    g_data = torch.autograd.grad(terms['flow_mse'] + terms['pres_mse'],
                                 list(params.values()), allow_unused=True,
                                 materialize_grads=True)
    torch.cuda.synchronize()
    results[path] = dict(
        terms={k: float(v.detach()) for k, v in terms.items()},
        data=dict(zip(params, g_data)), total=dict(zip(params, g_all)))
    if kernels:
      out.update(step_launches=step_counts, eval_launches=eval_counts)
    del model, params, loss, terms, g_all, g_data
    torch.cuda.empty_cache()
  k, p = results['kernel'], results['plain']
  tol = TOL[torch.float32]
  term_rel = {n: abs(k['terms'][n] - v) / abs(v) for n, v in p['terms'].items()}
  out.update(terms_kernel=k['terms'], terms_plain=p['terms'],
             term_rel=term_rel, tol=tol, leaves=len(posterior))
  failures = []
  log(f'  terms kernel {k["terms"]} plain {p["terms"]} (rel '
      + ', '.join(f'{n} {r:.2e}' for n, r in term_rel.items()) + ')')
  if not max(term_rel.values()) <= tol:
    failures.append(f'B-PINN terms: rel {term_rel}')
  for which in ('data', 'total'):
    worst, top3 = leaf_errors(k[which], p[which])
    finite = all(bool(torch.isfinite(v).all()) for v in k[which].values())
    out[f'{which}_grad'] = dict(max_leaf_rel=worst, worst_leaves=top3,
                                finite=finite)
    log(f'  {which} gradient in mu and rho ({len(posterior)} leaves), '
        'kernel vs plain: worst leaf rel to the largest leaf '
        + ', '.join(f'{n} {e:.2e}' for n, e in top3.items())
        + f' (limit {tol}), finite {finite}')
    if not (finite and worst <= tol):
      failures.append(f'B-PINN {which} gradient: worst leaf {worst:.3e}, '
                      f'finite {finite}')
  levels = k3_levels(config)
  want_step = {kernel: levels for kernel, _ in FLOW_KERNELS}
  want_eval = dict(want_step, correlation_df1=0, correlation_df2=0)
  log(f'  launches of one train step {out["step_launches"]} (expected '
      f'{want_step}); of one eval step {out["eval_launches"]} (expected '
      f'{want_eval})')
  if out['step_launches'] != want_step or out['eval_launches'] != want_eval:
    failures.append(f'B-PINN launches: step {out["step_launches"]}, eval '
                    f'{out["eval_launches"]}')
  del results, k, p
  torch.cuda.empty_cache()
  return out, failures


def _pinn_parts(params, part):
  """``{'<key>.<name>': tensor}`` of a flat posterior's ``part``."""
  return {f'{key}.{name}': v
          for key, parts in bayes.nest_posterior(params).items()
          for name, v in parts[part].items()}


def bpinn_pipeline(bpinn_steps, seed, workdir, name=None, profile=True):
  """The PINN pipeline at pinn_pde's full width on the synthetic PDE data
  (rolled out into an empty data directory): ``pinn_lib.train`` (phase 1
  for steps 0..2, phase 2 for steps 2..4), then ``train_bpinn`` from its
  last snapshot, first for its step 0 alone (at the warmup's lr 0 the
  state after it is the MOPED bootstrap), then for steps 0..
  ``bpinn_steps`` with the cadence cut so that log, eval, the preemption
  checkpoint and a snapshot fire, the launch counts set to 0 before and
  read after; one steady step profiled; a resume from the preemption
  checkpoint.  ``name``: the config (default ``BPINN_CONFIG``); without
  ``profile`` the steady step is not profiled.  Returns (report, the
  B-PINN snapshot, the bootstrapped PINN parameters (mu), failures)."""
  config = configs.get_config(name or BPINN_CONFIG)
  t = config.training
  t.n_iters, t.n_pinn_iters = 2, 2
  t.log_freq = t.eval_freq = t.snapshot_freq_for_preemption = 1000
  t.snapshot_freq = 2
  levels = k3_levels(config)
  failures = []
  pinn_dir = os.path.join(workdir, 'pinn')
  start = time.time()
  pinn_lib.train(config, pinn_dir, device='cuda')
  pinn_s = time.time() - start
  snapshot = os.path.join(pinn_dir, 'checkpoints', 'checkpoint_2')
  saved = torch.load(snapshot, map_location='cuda', weights_only=True)
  ema = saved['ema_params']

  # The bootstrap: step 0 alone moves nothing (lr 0).
  t.n_bpinn_iters = 0
  boot = pinn_lib.train_bpinn(config, os.path.join(workdir, 'boot'),
                              snapshot, device='cuda')
  delta = config.model.bpinn_moped_delta
  mu, rho = _pinn_parts(boot.params, 'mu'), _pinn_parts(boot.params, 'rho')
  mu_exact = mu.keys() == ema.keys() and all(
      torch.equal(mu[n], w) for n, w in ema.items())
  rho_exact = all(torch.equal(rho[n], bayes.inv_softplus(delta * w.abs()))
                  for n, w in ema.items())
  boot_params = {k: v.detach().clone() for k, v in boot.params.items()}
  del boot

  t.n_bpinn_iters = bpinn_steps
  t.log_freq = t.eval_freq = bpinn_steps // 2
  t.snapshot_freq_for_preemption = bpinn_steps // 2
  t.snapshot_freq = bpinn_steps
  bpinn_dir = os.path.join(workdir, 'bpinn')
  history = []
  reset_counts()
  torch.cuda.reset_peak_memory_stats()
  torch.cuda.synchronize()
  start = time.time()
  state = pinn_lib.train_bpinn(config, bpinn_dir, snapshot, device='cuda',
                               history=history)
  torch.cuda.synchronize()
  total_s = time.time() - start
  peak = torch.cuda.max_memory_allocated()
  launches = dict(flow_counts(), ns_step_fused=k4.ns_step_fused.launches)
  fired = collections.Counter(e for h in history for e in h['events'])
  n_steps = len(history)
  expected = {'correlation': levels * (n_steps + fired['eval']),
              'correlation_df1': levels * n_steps,
              'correlation_df2': levels * n_steps,
              'ns_step_fused': 0}            # the rollout read from its file
  moved = sum(not torch.equal(boot_params[n], v)
              for n, v in state.params.items())
  counts = {label: s.count for label, s in state.opt_state.items()}
  final_step = state.step
  snapshots = sorted(os.listdir(os.path.join(bpinn_dir, 'checkpoints')))
  bpinn_snapshot = os.path.join(bpinn_dir, 'checkpoints', 'checkpoint_1')

  # One steady step profiled, on the trained state.
  profile_out = None
  if profile:
    model, _ = init_pinn(config, device='cuda')
    tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.05,
                                        is_bpinn=True)
    step_fn = bayes.get_bpinn_prelim_step_fn(config, model, tx, train=True)
    batch, mask, _ = prelim_batch(config, seed)
    g = torch.Generator(device='cuda').manual_seed(seed)
    step_fn(state, mask, batch, g)
    profile_out, _ = profiled('B-PINN train step (batch 64, f32)',
                              lambda: step_fn(state, mask, batch, g))
    del model
  del state

  t.n_bpinn_iters = bpinn_steps + 2
  resumed_history = []
  resumed = pinn_lib.train_bpinn(config, bpinn_dir, snapshot, device='cuda',
                                 history=resumed_history)
  resumed_steps = [h['step'] for h in resumed_history]
  resumed_final = resumed.step
  del resumed

  it = iter(get_dataset(config, device='cuda')[0])
  next(it)
  start = time.perf_counter()
  for _ in range(5):
    next(it)
  batch_s = (time.perf_counter() - start) / 5

  steady = [h['seconds'] for h in history[2:] if not h['events']]
  step_s = float(np.mean(steady))
  losses_ = [h['loss'] for h in history]
  bs = t.batch_size
  families = profile_out['families'] if profile else {}
  report = dict(
      pinn_train_s=pinn_s, bootstrap_mu_exact=mu_exact,
      bootstrap_rho_exact=rho_exact, steps=n_steps, events=dict(fired),
      total_s=total_s, steady_step_s=step_s, samples_per_s=bs / step_s,
      steady_steps_timed=len(steady), batch_assembly_s=batch_s,
      first_step_s=history[0]['seconds'],
      event_step_s={h['step']: h['seconds'] for h in history if h['events']},
      losses=losses_, max_memory_allocated=peak, launches=launches,
      expected_launches=expected, snapshots=snapshots, params_moved=moved,
      leaves=len(boot_params), adam_counts=counts, final_step=final_step,
      resumed_steps=resumed_steps, resumed_final_step=resumed_final,
      profile=profile_out,
      k3_device_ms=families.get('K3 correlation', (0, 0.0))[1],
      k3_bwd_device_ms=families.get('K3 correlation backward', (0, 0.0))[1])
  log(f'  pinn_lib.train (3 + 3 steps) {pinn_s:.1f} s; bootstrap from '
      f'checkpoint_2: mu == its ema_params bit for bit {mu_exact}, rho == '
      f'inv_softplus(delta |w|) {rho_exact}')
  log(f'  train_bpinn: {n_steps} steps in {total_s:.2f} s (set-up '
      f'included; events {dict(fired)}); steady step {step_s:.4f} s (mean '
      f'of {len(steady)} event-free steps after the first two, '
      f'synchronised): {bs / step_s:.1f} samples/s; first step '
      f'{history[0]["seconds"]:.2f} s; of a step, the batch\'s assembly on '
      f'the host {batch_s:.4f} s')
  log(f'  losses: first {losses_[0]:.2f}, last {losses_[-1]:.2f}, all finite '
      f'{bool(np.isfinite(losses_).all())}; peak memory {peak / 2**30:.2f} '
      'GiB (torch.cuda.max_memory_allocated)')
  log(f'  launches {launches} (expected {expected}); snapshots {snapshots}; '
      f'mu and rho leaves moved {moved} of {len(boot_params)}; Adam counts '
      f'{counts}; final step {final_step}; resumed {resumed_steps} to step '
      f'{resumed_final}')
  if profile:
    log(f'  profiled step: K3 {report["k3_device_ms"]:.3f} ms, B1 + B2 '
        f'{report["k3_bwd_device_ms"]:.3f} ms of device time')
  if not (mu_exact and rho_exact):
    failures.append(f'B-PINN bootstrap: mu exact {mu_exact}, rho exact '
                    f'{rho_exact}')
  if not np.isfinite(losses_).all():
    failures.append('B-PINN: a loss is not finite')
  for name, n in expected.items():
    if launches[name] != n:
      failures.append(f'B-PINN {name}: {launches[name]} launches, expected '
                      f'{n}')
  if set(fired) != {'log', 'eval', 'preempt_ckpt', 'snapshot'}:
    failures.append(f'B-PINN: events {dict(fired)}')
  if snapshots != ['checkpoint_1']:
    failures.append(f'B-PINN: snapshots {snapshots}')
  if moved != len(boot_params):
    failures.append(f'B-PINN: {moved} of {len(boot_params)} leaves moved')
  if counts != {'flow': n_steps, 'pres': n_steps}:
    failures.append(f'B-PINN: Adam counts {counts}, expected {n_steps}')
  want_resumed = [bpinn_steps + 1, bpinn_steps + 2]
  if resumed_steps != want_resumed or resumed_final != bpinn_steps + 3:
    failures.append(f'B-PINN: resumed {resumed_steps} to '
                    f'{resumed_final}; expected {want_resumed}')
  return report, bpinn_snapshot, _pinn_parts(boot_params, 'mu'), failures


def bpinn_ukf_phase(ckpt, workdir, cycles=3, name=None):
  """``ukf_lib.run(ckptdir=<the B-PINN snapshot>)`` at full width for
  ``cycles`` cycles: the posterior it filters with against the snapshot's
  ``ema_params``, the belief, ``ukf.png`` and the launch counts.
  ``name``: the config (default ``BPINN_CONFIG``).  Returns (report,
  failures)."""
  config = configs.get_config(name or BPINN_CONFIG)
  saved = torch.load(ckpt, map_location='cuda', weights_only=True)
  handed = []
  real_kf = ukf_lib.PINN_KF

  def spy(config, model, bparams):
    handed.append(bparams)
    return real_kf(config, model, bparams)

  reset_counts()
  ukf_lib.PINN_KF = spy
  try:
    mse = ukf_lib.run(config, workdir, n_steps=cycles, device='cuda',
                      ckptdir=ckpt)
  finally:
    ukf_lib.PINN_KF = real_kf
  launches = {'correlation': k3.correlation.launches,
              'ns_step_fused': k4.ns_step_fused.launches}
  levels = k3_levels(config)
  expected = {'correlation': levels * cycles,
              'ns_step_fused': cycles + max(cycles + 2, 64) - 1}
  got = bayes.flatten_posterior(handed[0])
  restored = got.keys() == saved['ema_params'].keys() and all(
      torch.equal(got[k], v) for k, v in saved['ema_params'].items())
  belief = np.load(os.path.join(workdir, 'ukf_belief.npz'))
  diag = np.diagonal(belief['sqrt_cov'], axis1=-2, axis2=-1)
  finite = bool(np.isfinite(belief['mean']).all()
                and np.isfinite(belief['sqrt_cov']).all() and np.isfinite(mse))
  with open(os.path.join(workdir, 'ukf.png'), 'rb') as fh:
    png = fh.read(8) == PNG_SIGNATURE
  report = dict(f_mse=mse, restored_is_ema=restored, finite=finite,
                min_sqrt_cov_diag=float(diag.min()), png=png, cycles=cycles,
                launches=launches, expected_launches=expected)
  log(f'  ukf from the B-PINN snapshot, {cycles} cycles: posterior == its '
      f'ema_params {restored}; f-MSE {mse:.4e}; finite {finite}, min '
      f'sqrt-cov diagonal {diag.min():.3e}; ukf.png {png}; launches '
      f'{launches} (expected {expected})')
  failures = []
  if not (restored and finite and diag.min() >= 0 and png
          and launches == expected):
    failures.append(f'ukf from the B-PINN snapshot: {report}')
  return report, failures


def simulator_phase(boot_mu, workdir, n_steps=100, frames=10):
  """``simulator.run`` for ``n_steps`` at pinn_pde's 64x64 (K4 at batch
  1), the launch counts set to 0 before and read after; the kernel
  rollout against the plain rollout (``ns_step`` on the same fields) step
  by step; ``simulate`` for ``frames`` frames with the bootstrapped PINN's
  mu (K3 at batch 1).  Returns (report, failures)."""
  config = configs.get_config(BPINN_CONFIG)
  size = config.data.image_size
  reset_counts()
  mses = simulator.run(config, None, workdir, n_steps=n_steps, device='cuda')
  launches = {'ns_step_fused': k4.ns_step_fused.launches}
  expected = {'ns_step_fused': max(n_steps + 2, 64) - 1 + n_steps}
  data = ns_rollout(3, size, size, config.seed, device='cuda')
  kernel, _, _ = simulator.step_rollout(data, t_range=(0, n_steps))
  fields = [data[0, c][None] for c in range(2, 6)]
  gaps = []
  with torch.no_grad():
    for i in range(n_steps):
      fields = list(k4.ns_step(*fields, simulator.DT, simulator.DX))
      gaps.append(rel_err(kernel[i], fields[0])[1])
  model, _ = init_pinn(config, device='cuda')
  reset_counts()
  result, vel = simulator.simulate(model, boot_mu, config, data,
                                   t_range=(0, frames))
  corr = k3.correlation.launches
  finite = all(bool(torch.isfinite(f).all()) for f in result + vel)
  report = dict(mses_every_10=mses[::10], final_mse=mses[-1],
                launches=launches, expected_launches=expected,
                rollout_gap_every_10=gaps[::10], first_step_gap=gaps[0],
                simulate_frames=len(result), simulate_finite=finite,
                simulate_k3_launches=corr)
  log(f'  simulator.run {n_steps} steps at {size}x{size}: MSE vs the '
      f'rollout every 10 steps {[f"{m:.3e}" for m in mses[::10]]}; '
      f'launches {launches} (expected {expected})')
  log(f'  kernel vs plain rollout, rel gap every 10 steps '
      f'{[f"{e:.2e}" for e in gaps[::10]]} (first step {gaps[0]:.2e}, '
      f'limit {TOL[torch.float32]})')
  log(f'  simulate {frames} frames with the bootstrapped mu: finite '
      f'{finite}, K3 launches {corr} (batch 1)')
  failures = []
  if not (gaps[0] <= TOL[torch.float32] and launches == expected
          and finite and np.isfinite(mses).all()
          and corr == frames * len(config.model.feature_nums)):
    failures.append(f'simulator: {report}')
  return report, failures


def cli_phase(ckpt, workdir, name=None):
  """``python -m b_pinn_kalman_filter_tpu_torch --mode ukf --ckptdir
  <ckpt>`` on the port's config ``name`` (default ``BPINN_CONFIG``), as a
  subprocess.  Returns (report, failures)."""
  root = os.path.dirname(os.path.abspath(__file__))
  cmd = [sys.executable, '-m', 'b_pinn_kalman_filter_tpu_torch', '--config',
         os.path.join(root, 'b_pinn_kalman_filter_tpu_torch', 'configs',
                      f'{name or BPINN_CONFIG}.py'),
         '--workdir', workdir, '--mode', 'ukf', '--ckptdir', ckpt]
  start = time.time()
  proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                        timeout=600)
  seconds = time.time() - start
  mse_path = os.path.join(workdir, 'ukf_mse.txt')
  mse = float(open(mse_path).read()) if os.path.exists(mse_path) else None
  png_path = os.path.join(workdir, 'ukf.png')
  png = os.path.exists(png_path) and open(png_path, 'rb').read(8) == (
      PNG_SIGNATURE)
  report = dict(returncode=proc.returncode, seconds=seconds, f_mse=mse,
                png=png)
  log(f'  {" ".join(cmd[1:4])} {name or BPINN_CONFIG} --mode ukf --ckptdir '
      f'<B-PINN snapshot>: exit '
      f'{proc.returncode} in {seconds:.1f} s, ukf_mse.txt {mse}, ukf.png '
      f'{png}')
  failures = []
  if proc.returncode != 0 or mse is None or not np.isfinite(mse) or not png:
    failures.append(f'CLI ukf: {report}; stderr {proc.stderr[-2000:]}')
  return report, failures


def bpinn_phase(bpinn_steps, seed, name=None, simulate=True):
  """The B-PINN phase at the config ``name`` (default ``BPINN_CONFIG``):
  the full-width gradient check, then the pipeline (PINN, B-PINN (its
  step profiled for the default config), ukf from its snapshot, with
  ``simulate`` the simulator, the CLI) on a rollout made anew in an empty
  data directory.  Returns (report, failures)."""
  report, failures = {}, []
  log(f'[B-PINN ({name or BPINN_CONFIG}): one step\'s terms and gradients '
      'in mu and rho, kernel path vs plain path, batch 64, f32]')
  report['grads'], f = bpinn_grad_phase(seed, name)
  failures += f
  data_dir = os.environ.get('BPKF_DATA_DIR')
  with tempfile.TemporaryDirectory() as tmp:
    os.environ['BPKF_DATA_DIR'] = os.path.join(tmp, 'data')
    try:
      log(f'[B-PINN: pinn_lib.train, then train_bpinn from its snapshot, '
          f'steps 0..{bpinn_steps}; then a resume]')
      report['train'], ckpt, boot_mu, f = bpinn_pipeline(
          bpinn_steps, seed, tmp, name, profile=name is None)
      failures += f
      log('[B-PINN: ukf_lib.run from the B-PINN snapshot]')
      report['ukf'], f = bpinn_ukf_phase(ckpt, os.path.join(tmp, 'ukf'),
                                         name=name)
      failures += f
      if simulate:
        log('[B-PINN: simulator.run and simulate]')
        report['simulator'], f = simulator_phase(boot_mu,
                                                 os.path.join(tmp, 'sim'))
        failures += f
      log('[B-PINN: the CLI, --mode ukf from the B-PINN snapshot]')
      report['cli'], f = cli_phase(ckpt, os.path.join(tmp, 'cli'), name)
      failures += f
    finally:
      if data_dir is None:
        os.environ.pop('BPKF_DATA_DIR', None)
      else:
        os.environ['BPKF_DATA_DIR'] = data_dir
  return report, failures


LFN_CONFIG = 'pinn/pinn_pde_lfn'
# The LiteFlowNet's stride-1 levels at 64x64, (H = W, C): levels 6, 5, 4.
LFN_LEVELS = ((2, 192), (4, 128), (8, 96))


def lfn_kernel_phase(seed):
  """K3 and B1 + B2 at the LiteFlowNet's three stride-1 levels of
  ``LFN_CONFIG``, f32: K3 at the train batch (64, once a level a forward)
  and at the ukf's 8 draws folded into the batch (once a level a cycle);
  B1 and B2 at batch 64 (once a level a prelim step) with the
  second-order product.  The yardsticks are timed at FlowNet's levels
  only.  Returns (rows, totals, failures): the totals a forward (K3,
  batch 64), a cycle (K3, batch 8) and a prelim step (B1 + B2)."""
  config = configs.get_config(LFN_CONFIG)
  batch, draws = config.training.batch_size, ukf_lib.N_DRAWS
  tol = TOL[torch.float32]
  rows, failures = [], []
  for i, (b, (h, c)) in enumerate([(b, lv) for b in (batch, draws)
                                   for lv in LFN_LEVELS]):
    shape = (b, h, h, c)
    row = check_corr(shape, seed + i, yardstick=False)
    row.update(kernel='correlation', shape=list(shape), tol=tol)
    rows.append(row)
    log(f'  K3 {shape} rel {row["rel_err"]:.3e} | kernel {row["ms"]:.4f} ms '
        f'(call {row["call_ms"]:.4f}) plain {row["plain_ms"]:.4f} bound '
        f'{row["bound_ms"]:.6f} ({row["bound_by"]}) plan {row["plan"]}')
    if not (row['rel_err'] <= tol and row['same_bits_twice']):
      failures.append(f'LFN K3 {shape}: rel {row["rel_err"]:.3e}, same '
                      f'bits {row["same_bits_twice"]}')
  for i, (h, c) in enumerate(LFN_LEVELS):
    shape = (batch, h, h, c)
    row = check_corr_bwd(shape, seed + 10 + i, yardstick=False)
    row.update(kernel='correlation_bwd', shape=list(shape), tol=tol)
    rows.append(row)
    log(f'  B1+B2 {shape} rel df1 {row["df1"]["rel_err"]:.3e} df2 '
        f'{row["df2"]["rel_err"]:.3e} second order '
        f'{row["second_order_rel_err"]:.3e} | kernels {row["ms"]:.4f} ms '
        f'plain {row["plain_ms"]:.4f} bound {row["bound_ms"]:.6f} plan '
        f'{row["plan"]}')
    for key in ('df1', 'df2'):
      if not (row[key]['rel_err'] <= tol and row[key]['same_bits_twice']):
        failures.append(f'LFN {key} {shape}: {row[key]}')
    if not row['second_order_rel_err'] <= tol:
      failures.append(f'LFN second order {shape}: '
                      f'{row["second_order_rel_err"]:.3e}')

  def total(kernel, b):
    mine = [r for r in rows if r['kernel'] == kernel and r['shape'][0] == b]
    out = {k: sum(r[k] for r in mine)
           for k in ('ms', 'call_ms', 'plain_ms', 'bound_ms')}
    out.update(bound_by='bytes', library_ms=None,
               max_abs_err=max(r['max_abs_err'] for r in mine))
    return out

  totals = dict(forward=total('correlation', batch),
                cycle=total('correlation', draws),
                prelim_step_bwd=total('correlation_bwd', batch))
  log(f'  device ms: K3 a LiteFlowNet forward (batch {batch}, 3 launches) '
      f'{totals["forward"]["ms"]:.4f}, bound '
      f'{totals["forward"]["bound_ms"]:.6f}; a ukf cycle (batch {draws}) '
      f'{totals["cycle"]["ms"]:.4f}, bound {totals["cycle"]["bound_ms"]:.6f}'
      f'; B1 + B2 a prelim step (6 launches) '
      f'{totals["prelim_step_bwd"]["ms"]:.4f}, bound '
      f'{totals["prelim_step_bwd"]["bound_ms"]:.6f}')
  return rows, totals, failures


def lfn_forward_phase(seed):
  """One LiteFlowNet forward of ``LFN_CONFIG`` at full width (batch 64,
  64x64, f32) on every parameter randomised, kernel path against plain
  path: every flow of the cascade within the limit of its own max
  |plain|; the kernel path's K3 launches by image size (one at each of
  levels 6, 5 and 4); each path's host seconds, synchronised, of a second
  call.  Returns (report, failures)."""
  config = configs.get_config(LFN_CONFIG)
  f1, f2, x, y, t = prelim_batch(config, seed)[0][:5]
  flows, seconds = {}, {}
  for path, kernels in (('kernel', True), ('plain', False)):
    model = PINN(config, kernels=kernels).cuda()
    randomize_(model, seed)
    with torch.inference_mode():
      model.flownet(f1, f2, x, y, t)
      torch.cuda.synchronize()
      reset_counts()
      start = time.perf_counter()
      flows[path] = model.flownet(f1, f2, x, y, t)
      torch.cuda.synchronize()
      seconds[path] = time.perf_counter() - start
    if kernels:
      launches = k3.correlation.launches
      sizes = {f'{h}x{w}': n for (h, w), n in k3.correlation.sizes.items()}
    del model
  errs = [rel_err(a, b)[1] for a, b in zip(flows['kernel'], flows['plain'])]
  finite = all(bool(torch.isfinite(f).all()) for f in flows['kernel'])
  want_sizes = {f'{h}x{h}': 1 for h, _ in LFN_LEVELS}
  report = dict(flow_rel_errs=errs, finite=finite, k3_launches=launches,
                k3_launches_by_size=sizes, seconds=seconds,
                shapes=[list(f.shape) for f in flows['kernel']],
                tol=TOL[torch.float32])
  log(f'  flows {report["shapes"]}: rel {[f"{e:.2e}" for e in errs]} (limit '
      f'{TOL[torch.float32]}), finite {finite}; K3 launches {launches} by '
      f'size {sizes}; host s kernel {seconds["kernel"]:.4f}, plain '
      f'{seconds["plain"]:.4f}')
  failures = []
  if not (finite and max(errs) <= TOL[torch.float32]
          and sizes == want_sizes and launches == len(LFN_LEVELS)):
    failures.append(f'LFN forward: {report}')
  return report, failures


def lfn_residual_phase(seed):
  """The phase-2 residual of the LiteFlowNet-PINN at full width, kernel
  path against plain path, by its parts.  The LiteFlowNet reads no x, y
  or t, so its flows enter the residual only as the PressureNet's
  detached input, and the cost volumes' part in it is the flows' values.
  Held: the kernel path's flows against the plain path's; the residual's
  gradient in every LiteFlowNet leaf exactly zero on the kernel path (B1
  and B2 run on zero cotangents there); and the kernel path's residual
  and its gradient against the plain PressureNet's given the kernel
  path's flows.  Reported: the residual and its gradient kernel path
  against plain path, and, as the control, the plain path against itself
  with its flows moved by 1e-7 of their largest value at random (the
  PressureNet's instance norms amplify a change of the LiteFlowNet's
  nearly uniform flows).  Returns (report, failures)."""
  config = configs.get_config(LFN_CONFIG)
  batch, mask, noise = pinn_batch(config, seed)
  f1m, f2m = pinn_losses.masked_frames(config, batch, mask, None, noise)
  _, _, x, y, t, _ = batch
  models = {}
  for path, kernels in (('kernel', True), ('plain', False)):
    models[path] = PINN(config, kernels=kernels).cuda()
    randomize_(models[path], seed)
  with torch.no_grad():
    flows = {path: m.flownet(f1m, f2m, x, y, t) for path, m in models.items()}
  g = torch.Generator(device='cuda').manual_seed(seed + 3)
  moved = [f + 1e-7 * f.abs().max() * torch.randn(
      f.shape, generator=g, device='cuda') for f in flows['plain']]

  def residual(model, given=None):
    """The residual and its gradient in every leaf; the PressureNet on
    the flows ``given``, else on the model's own."""
    params = dict(model.named_parameters())
    if given is None:
      res = equation_mse_from_outputs(model, params, f1m, f2m, x, y, t,
                                      pinn_losses.RE)
    else:
      def uvp(x, y, t):
        pres = model.pressure_only(given, x, y, t)
        return given[-1][..., 0:1], given[-1][..., 1:2], pres
      res = equation_mse(uvp, x, y, t, pinn_losses.RE)
    grads = torch.autograd.grad(res, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return float(res.detach()), dict(zip(params, grads))

  kernel = residual(models['kernel'])
  plain = residual(models['plain'])
  given = residual(models['plain'], flows['kernel'])
  control = residual(models['plain'], moved)
  tol = TOL[torch.float32]
  flow_rel = max(rel_err(a, b)[1]
                 for a, b in zip(flows['kernel'], flows['plain']))
  flow_zero = all(float(v.abs().max()) == 0 for n, v in kernel[1].items()
                  if n.startswith('flownet.'))

  def compare(a, b):
    return abs(a[0] - b[0]) / abs(b[0]), leaf_errors(a[1], b[1])[0]

  report = dict(flow_rel=flow_rel, flownet_grad_zero=flow_zero,
                residual=kernel[0], tol=tol,
                given_kernel_flows=compare(kernel, given),
                kernel_vs_plain=compare(kernel, plain),
                control_1e7=compare(control, plain),
                flow_spatial_std_over_max=[
                    float(f.std(dim=(1, 2)).min() / f.abs().max())
                    for f in flows['plain']])
  log(f'  flows kernel vs plain rel {flow_rel:.2e}; residual gradient in '
      f'every flownet leaf zero {flow_zero}; residual {kernel[0]:.4e} and '
      f'its gradient vs the plain PressureNet given the kernel flows (rel, '
      f'worst leaf) {report["given_kernel_flows"]} (limit {tol})')
  log(f'  reported: kernel vs plain {report["kernel_vs_plain"]}; control, '
      f'the plain path with its flows moved by 1e-7 of their max '
      f'{report["control_1e7"]}; the flows\' least spatial std over their '
      f'max by level '
      f'{[f"{v:.3f}" for v in report["flow_spatial_std_over_max"]]}')
  failures = []
  if not (flow_rel <= tol and flow_zero
          and max(report['given_kernel_flows']) <= tol):
    failures.append(f'LFN residual: {report}')
  del models, flows, kernel, plain, given, control
  torch.cuda.empty_cache()
  return report, failures


def lfn_prelim_step_phase(seed, steps=3):
  """Steady prelim train steps of the LiteFlowNet-PINN at full width
  (after a warm one), each synchronised: their mean seconds, samples/s and
  the peak memory.  Returns the report."""
  config = configs.get_config(LFN_CONFIG)
  model, _ = init_pinn(config, device='cuda')
  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.001)
  state = state_lib.create_train_state(dict(model.named_parameters()), tx,
                                       config.model.ema_rate)
  step_fn = pinn_losses.get_prelim_step_fn(config, model, tx, train=True)
  batch, mask, _ = prelim_batch(config, seed)
  g = torch.Generator(device='cuda').manual_seed(seed)
  step_fn(state, mask, batch, g)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  seconds = []
  for _ in range(steps):
    start = time.perf_counter()
    step_fn(state, mask, batch, g)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - start)
  bs = config.training.batch_size
  step_s = float(np.mean(seconds))
  out = dict(step_seconds=seconds, steady_step_s=step_s,
             samples_per_s=bs / step_s,
             max_memory_allocated=torch.cuda.max_memory_allocated())
  log(f'  prelim step {step_s:.4f} s (mean of {steps}, synchronised): '
      f'{bs / step_s:.1f} samples/s; peak memory '
      f'{out["max_memory_allocated"] / 2**30:.2f} GiB')
  del model, state
  torch.cuda.empty_cache()
  return out


def lfn_phase(args):
  """The LiteFlowNet-PINN (``LFN_CONFIG``) at full width: its kernels,
  one forward and one prelim step kernel path against plain path, a
  profiled prelim step, the phase-2 loss kernel path against plain path,
  ``pinn_lib.train`` (phase 1, then phase 2), the B-PINN pipeline
  (``train_bpinn`` from a PINN snapshot, ``ukf_lib.run`` from its
  snapshot, the CLI's ``--mode ukf``).  Returns (report, failures)."""
  report, failures = {}, []
  config = configs.get_config(LFN_CONFIG)
  bs = config.training.batch_size
  log(f'[LiteFlowNet: K3 at levels 6, 5, 4 vs plain (batch {bs} and '
      f'{ukf_lib.N_DRAWS}), B1 and B2 (batch {bs}), f32]')
  report['kernels'], report['kernel_totals'], f = lfn_kernel_phase(
      args.seed)
  failures += f
  log(f'[LiteFlowNet: one forward, kernel path vs plain path, batch {bs}, '
      '64x64, f32]')
  report['forward'], f = lfn_forward_phase(args.seed)
  failures += f
  log(f'[LiteFlowNet: one prelim step\'s loss and gradients, kernel path vs '
      f'plain path, batch {bs}, f32]')
  report['prelim_grads'], f = prelim_grad_phase(args.seed, LFN_CONFIG)
  failures += f
  log('[LiteFlowNet: steady prelim steps]')
  report['prelim_step'] = lfn_prelim_step_phase(args.seed)
  log(f'[LiteFlowNet: one phase-2 step\'s residual, losses and gradients, '
      f'kernel path vs plain path, batch {bs}, f32]')
  report['pinn_grads'], f = pinn_grad_phase(args.seed, LFN_CONFIG)
  failures += f
  log(f'[LiteFlowNet: the phase-2 residual by its parts, kernel path vs '
      f'plain path, batch {bs}, f32]')
  report['residual'], f = lfn_residual_phase(args.seed)
  failures += f
  log(f'[LiteFlowNet: pinn_lib.train, phase 1 steps 0..2, phase 2 steps '
      f'2..{2 + args.lfn_pinn_steps}; then a resume]')
  report['pinn'], report['pinn_launches'], f = pinn_phase(
      args.lfn_pinn_steps, report['pinn_grads']['step_launches'],
      report['pinn_grads']['eval_launches'], args.seed, LFN_CONFIG)
  failures += f
  bpinn, f = bpinn_phase(args.lfn_bpinn_steps, args.seed, LFN_CONFIG,
                         simulate=False)
  report['bpinn'] = bpinn
  failures += f
  return report, failures


NC_TRAIN_CONFIG = 'vp/nc_ddpmpp'


def nc_train_phase(train_steps, per_forward, seed, name=NC_TRAIN_CONFIG,
                   batch_size=None):
  """``run_lib.train`` at ``NC_TRAIN_CONFIG`` (the NC U-Net: nf 128,
  ch_mult (1,2,2,2), 4 res blocks, 64x64x1, batch 64, bf16) through the
  discrete DDPM loss, for steps 0..``train_steps``, on the NC stand-in
  (the JAX package's seeded 512x456x256 field), the launch counts set to
  0 before and read after: per step K1 at every forward site and as the
  data gradient at every site, K2 at every forward site (and the eval's
  forward), and K1's launches by kernel.  Cut: no snapshot sampling (the
  config's N = 2000 ancestral steps), the eval at the first step only.
  Checks: finite losses, parameters moved, launches.  Returns (report,
  failures).  ``name`` and ``batch_size`` run another config the same
  way (NCSN++: the continuous DSM loss)."""
  config = configs.get_config(name)
  t = config.training
  t.batch_size = batch_size or t.batch_size
  t.n_iters = train_steps
  t.snapshot_sampling = False
  t.log_freq = t.eval_freq = t.snapshot_freq_for_preemption = 10 ** 6
  t.snapshot_freq = 10 ** 6
  history = []
  with tempfile.TemporaryDirectory() as workdir:
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    start = time.time()
    state = run_lib.train(config, workdir, device='cuda', history=history)
    torch.cuda.synchronize()
    total_s = time.time() - start
    snapshots = sorted(os.listdir(os.path.join(workdir, 'checkpoints')))
  peak = torch.cuda.max_memory_allocated()
  launches = {'conv3x3': dict(k1.conv3x3.launches_by_use),
              'conv3x3_by_kernel': dict(k1.conv3x3.launches_by_kernel),
              'groupnorm_act': k2.groupnorm_act.launches}
  fired = collections.Counter(e for h in history for e in h['events'])
  n_steps = len(history)
  forwards = n_steps + fired['eval']
  expected = {'conv3x3': {'forward': per_forward['conv3x3'] * forwards,
                          'data_grad': per_forward['conv3x3'] * n_steps,
                          'jvp': 0},
              'groupnorm_act': per_forward['groupnorm_act'] * forwards}
  init = registry.create_model(config, device='cuda', seed=config.seed)
  moved = sum(not torch.equal(p, state.params[n])
              for n, p in init.named_parameters())
  del init, state
  losses_ = [h['loss'] for h in history]
  steady = [h['seconds'] for h in history[2:] if not h['events']]
  step_s = float(np.mean(steady)) if steady else history[-1]['seconds']
  report = dict(steps=n_steps, events=dict(fired), total_s=total_s,
                steady_step_s=step_s, imgs_per_s=t.batch_size / step_s,
                steady_steps_timed=len(steady),
                first_step_s=history[0]['seconds'], losses=losses_,
                max_memory_allocated=peak, launches=launches,
                expected_launches=expected, params_moved=moved,
                snapshots=snapshots,
                per_step=dict(conv3x3=per_forward['conv3x3'],
                              conv3x3_data_grad=per_forward['conv3x3'],
                              groupnorm_act=per_forward['groupnorm_act']))
  log(f'  {n_steps} steps in {total_s:.2f} s (model, NC data and set-up '
      f'included; events {dict(fired)}); steady step {step_s:.4f} s (mean '
      f'of {len(steady)} event-free steps after the first two, '
      f'synchronised): {t.batch_size / step_s:.1f} imgs/s; first step '
      f'{history[0]["seconds"]:.2f} s')
  log(f'  losses {[f"{v:.5f}" for v in losses_]}; peak memory '
      f'{peak / 2**30:.2f} GiB; parameters moved {moved}; launches '
      f'{launches} (expected {expected}); snapshots {snapshots}')
  failures = []
  if not np.isfinite(losses_).all():
    failures.append(f'{name} train: a loss is not finite')
  if not moved:
    failures.append(f'{name} train: no parameter moved')
  if (launches['conv3x3'] != expected['conv3x3']
      or launches['groupnorm_act'] != expected['groupnorm_act']):
    failures.append(f'{name} train launches {launches}, expected '
                    f'{expected}')
  return report, failures


INVERSE_CONFIG = 'inverse/nc_ddpmpp_inpaint_dps'


def nc_model(dtype, kernels, seed):
  """The NC U-Net of ``INVERSE_CONFIG`` (nf 128, ch_mult (1,2,2,2), 4 res
  blocks, attention at 16^2, 64x64x1) in ``dtype``, every parameter
  randomised."""
  return randomized_model(INVERSE_CONFIG, dtype, kernels, seed)


def inverse_counts():
  return {'conv3x3': dict(k1.conv3x3.launches_by_use),
          'conv3x3_by_kernel': dict(k1.conv3x3.launches_by_kernel),
          'groupnorm_act': k2.groupnorm_act.launches}


def inverse_problem(config, seed):
  """(a random [0, 1] batch of the config's shape, its operator with the
  config's first mask, the flat observation, the shape)."""
  batch, size = config.training.batch_size, config.data.image_size
  shape = (batch, size, size, config.data.num_channels)
  g = torch.Generator(device='cuda').manual_seed(seed)
  origin = torch.rand(shape, generator=g, device='cuda')
  op = operators.get_operator(config, device='cuda')
  return origin, op, op(origin, keep_shape=False), shape


def guided_eval_phase(seed):
  """One DPS guided evaluation (the score and ``score_cond`` through the
  U-Net and back) at full width and batch, kernel path against plain path
  on the same randomised parameters, x and t, in f32 (TF32 off) and bf16,
  with the kernels' launches counted over it.  Returns (report, per-eval
  launches of the bf16 kernel path, failures)."""
  out, failures, per_eval = {}, [], None
  for dtype in (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    config, kernel_model = nc_model(dtype, True, seed)
    _, plain_model = nc_model(dtype, False, seed)
    sde, _ = sde_lib.get_sde(config)
    origin, op, y, shape = inverse_problem(config, seed)
    g = torch.Generator(device='cuda').manual_seed(seed + 1)
    x = torch.randn(shape, generator=g, device='cuda')
    t = torch.full((shape[0],), 0.5, device='cuda')
    results = {}
    for path, model in (('kernel', kernel_model), ('plain', plain_model)):
      params = {k: v.detach() for k, v in model.named_parameters()}
      score_fn = registry.get_score_fn(sde, model, continuous=True,
                                       params=params)
      guidance = cs.dps_guidance(sde, score_fn, y, op,
                                 config.inverse.variance)
      reset_counts()
      score, cond = guidance(x, t)
      torch.cuda.synchronize()
      results[path] = (score, cond, inverse_counts(),
                       time_ms(lambda: guidance(x, t), 3, 1))
    (k_score, k_cond, k_counts, k_ms), (p_score, p_cond, p_counts, p_ms) = (
        results['kernel'], results['plain'])
    errs = {'score': rel_err(k_score, p_score)[1],
            'score_cond': rel_err(k_cond, p_cond)[1]}
    finite = bool(torch.isfinite(k_score).all() and torch.isfinite(k_cond)
                  .all())
    out[name] = dict(rel_err=errs, tol=TOL[dtype], kernel_counts=k_counts,
                     plain_counts=p_counts, kernel_eval_ms=k_ms,
                     plain_eval_ms=p_ms,
                     max_abs_score_cond=float(p_cond.abs().max()))
    log(f'  guided eval {name}, batch {shape[0]}: score rel '
        f'{errs["score"]:.3e}, score_cond rel {errs["score_cond"]:.3e} '
        f'(limit {TOL[dtype]}); kernel path {k_ms:.2f} ms, plain path '
        f'{p_ms:.2f} ms a guided evaluation (host clock); launches '
        f'{k_counts}')
    if not (finite and max(errs.values()) <= TOL[dtype]):
      failures.append(f'guided eval {name}: {errs}, finite {finite}')
    if (p_counts['groupnorm_act'] or sum(p_counts['conv3x3'].values())):
      failures.append(f'guided eval {name}: the plain path launched '
                      f'{p_counts}')
    if dtype == torch.bfloat16:
      per_eval = dict(conv3x3=k_counts['conv3x3']['forward'],
                      conv3x3_data_grad=k_counts['conv3x3']['data_grad'],
                      groupnorm_act=k_counts['groupnorm_act'])
    del kernel_model, plain_model, results
    torch.cuda.empty_cache()
  return out, per_eval, failures


def request_counts(per_eval, nfe):
  return {k: v * nfe for k, v in per_eval.items()}


def inverse_phase(fixed_steps, per_eval, seed):
  """The inverse suite at ``INVERSE_CONFIG``'s full width and batch, bf16:
  ``inverse_lib.inverse`` by the guided DPM-Solver++ (``dpm``, 50 steps)
  from a checkpoint of randomised weights (seconds, NFE, launches, peak
  memory), the same request on the built model again and one guided
  evaluation under the profiler; the controlled sampler by RK45 (NFE,
  status, seconds); DPS by ``fixed`` at ``fixed_steps``.  Returns
  (report, failures)."""
  report, failures = {}, []
  config, model = nc_model(torch.bfloat16, True, seed)
  config.inverse.solver = 'dpm'
  steps = config.inverse.dpm_steps
  with tempfile.TemporaryDirectory() as tmp:
    state = state_lib.create_train_state(dict(model.named_parameters()),
                                         losses.get_optimizer(config),
                                         config.model.ema_rate)
    ckpt = os.path.join(tmp, 'checkpoint')
    ckpt_lib.save_checkpoint(ckpt, state)
    del state
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    info = {}
    start = time.time()
    origin, _, sample, mse = inverse_lib.inverse(
        config, ckpt, os.path.join(tmp, 'work'), device='cuda', info=info)
    torch.cuda.synchronize()
    seconds = time.time() - start
    launches = inverse_counts()
    peak = torch.cuda.max_memory_allocated()
    outdir = os.path.join(tmp, 'work', 'inpaint-0.5')
    files = sorted(os.listdir(outdir))
  finite = bool(torch.isfinite(sample).all())
  want = request_counts(per_eval, info['nfe'])
  got = dict(conv3x3=launches['conv3x3']['forward'],
             conv3x3_data_grad=launches['conv3x3']['data_grad'],
             groupnorm_act=launches['groupnorm_act'])
  report['dps_dpm'] = dict(
      seconds=seconds, nfe=info['nfe'], mse=mse, finite=finite, files=files,
      launches=got, peak_gib=peak / 2 ** 30,
      held_gib=(torch.cuda.memory_allocated() - before) / 2 ** 30,
      shape=list(sample.shape))
  log(f'  inverse_lib.inverse, dpm {steps} steps, from a checkpoint: '
      f'{seconds:.2f} s (model, checkpoint, NC data and PNGs included), '
      f'nfe {info["nfe"]}, mse {mse:.4e}, finite {finite}, files {files}, '
      f'peak {peak / 2 ** 30:.2f} GiB, launches {got}')
  if not (finite and info['nfe'] == steps + 1 and got == want and files == [
      'inverse.png', 'mse.txt', 'observation.png']):
    failures.append(f'inverse dpm: {report["dps_dpm"]}, launches expected '
                    f'{want}')

  # The same request on the built model, the weights on the card: the
  # serving time of a posterior sample.
  sde, eps = sde_lib.get_sde(config)
  op = operators.InpaintOperator(mask=torch.rand(
      origin.shape[1:3] + (1,), device='cuda').round())
  obsv = obsv_sde.LOBSVSDE(sde, op(origin, keep_shape=False), op)
  shape = tuple(origin.shape)
  gen = torch.Generator(device='cuda')
  dps = cs.get_dps_sampler(config, obsv, shape, eps=eps, device='cuda')
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  before = torch.cuda.memory_allocated()
  start = time.time()
  sample = dps(model, generator=gen.manual_seed(seed))
  torch.cuda.synchronize()
  request_s = time.time() - start
  # Each evaluation's graph is released when its gradient is taken: the
  # request holds no more memory after it than the sample.
  held = torch.cuda.memory_allocated() - before - sample.numel() * 4
  report['dps_dpm'].update(request_s=request_s,
                           request_peak_gib=torch.cuda.max_memory_allocated()
                           / 2 ** 30, request_held_bytes=held)
  log(f'  DPS dpm request on the built model: {request_s:.3f} s '
      f'({request_s / (steps + 1) * 1e3:.1f} ms a guided evaluation), peak '
      f'{report["dps_dpm"]["request_peak_gib"]:.2f} GiB, held after it '
      f'beyond the sample {held} bytes')
  if held > 2 ** 20:
    failures.append(f'DPS dpm request held {held} bytes after it')
  params = {k: v.detach() for k, v in model.named_parameters()}
  guidance = cs.dps_guidance(
      sde, registry.get_score_fn(sde, model, continuous=True, params=params),
      obsv.y0, op, config.inverse.variance)
  t = torch.full((shape[0],), 0.5, device='cuda')
  guidance(sample, t)
  report['guided_eval_profile'], _ = profiled(
      'one DPS guided evaluation (batch 16, 64x64, bf16)',
      lambda: guidance(sample, t))

  controlled_config = configs.get_config(INVERSE_CONFIG)
  controlled_config.inverse.sampler = 'controlled'
  controlled = cs.get_controlled_sampler(
      controlled_config, obsv, shape, lambda t: (1.0 - t) * 0.8, eps=eps,
      device='cuda')
  info = {}
  torch.cuda.synchronize()
  start = time.time()
  sample = controlled(model, generator=gen.manual_seed(seed), info=info)
  torch.cuda.synchronize()
  seconds = time.time() - start
  finite = bool(torch.isfinite(sample).all())
  report['controlled_rk45'] = dict(seconds=seconds, finite=finite, **info)
  log(f'  controlled sampler, RK45: {seconds:.2f} s, nfe {info["nfe"]}, '
      f'status {info["status"]}, finite {finite}')
  if not (finite and info['status'] == 0):
    failures.append(f'controlled RK45: {report["controlled_rk45"]}')

  config.inverse.solver, config.inverse.fixed_steps = 'fixed', fixed_steps
  dps = cs.get_dps_sampler(config, obsv, shape, eps=eps, device='cuda')
  reset_counts()
  info = {}
  torch.cuda.synchronize()
  start = time.time()
  sample = dps(model, generator=gen.manual_seed(seed), info=info)
  torch.cuda.synchronize()
  seconds = time.time() - start
  finite = bool(torch.isfinite(sample).all())
  got = inverse_counts()['conv3x3']
  report['dps_fixed'] = dict(seconds=seconds, finite=finite, steps=fixed_steps,
                             nfe=info['nfe'], launches=got)
  log(f'  DPS, fixed, {fixed_steps} of the reference\'s 5000 steps: '
      f'{seconds:.2f} s, nfe {info["nfe"]}, finite {finite}, conv3x3 '
      f'launches {got}')
  if not (finite and info['nfe'] == fixed_steps
          and got['data_grad'] == per_eval['conv3x3_data_grad'] * fixed_steps):
    failures.append(f'DPS fixed: {report["dps_fixed"]}')
  del model
  torch.cuda.empty_cache()
  return report, failures


def dpm_sample_phase(model, per_forward, seed, steps=20):
  """``run_lib.sample`` at the flagship, ``sampling.method='dpm_solver'``,
  batch 8, ``steps`` steps (and the denoising prediction).  Returns
  (report, failures)."""
  config = model.config
  config.sampling.method, config.sampling.dpm_steps = 'dpm_solver', steps
  reset_counts()
  torch.cuda.synchronize()
  start = time.time()
  samples, nfe = run_lib.sample(config, batch_size=BATCH, seed=seed,
                                device='cuda', model=model)
  torch.cuda.synchronize()
  seconds = time.time() - start
  config.sampling.method = 'pc'
  finite = bool(torch.isfinite(samples).all())
  launches = {'conv3x3': k1.conv3x3.launches,
              'groupnorm_act': k2.groupnorm_act.launches}
  report = dict(seconds=seconds, imgs_per_s=BATCH / seconds, nfe=nfe,
                finite=finite, launches=launches)
  log(f'  run_lib.sample, dpm_solver, {steps} steps, batch {BATCH}: '
      f'{seconds:.3f} s, {BATCH / seconds:.2f} imgs/s, nfe {nfe}, finite '
      f'{finite}, launches {launches}')
  failures = []
  if not (finite and nfe == steps + 1 and all(
      launches[k] == per_forward[k] * nfe for k in launches)):
    failures.append(f'dpm_solver sample: {report}')
  return report, failures


def inverse_cli_phase(workdir):
  """``python -m b_pinn_kalman_filter_tpu_torch --mode inverse`` on the
  port's ``INVERSE_CONFIG`` with ``inverse.solver=dpm`` (the seeded init,
  no checkpoint), as a subprocess.  Returns (report, failures)."""
  root = os.path.dirname(os.path.abspath(__file__))
  cmd = [sys.executable, '-m', 'b_pinn_kalman_filter_tpu_torch', '--config',
         os.path.join(root, 'b_pinn_kalman_filter_tpu_torch', 'configs',
                      *INVERSE_CONFIG.split('/')) + '.py',
         '--workdir', workdir, '--mode', 'inverse',
         '--config.inverse.solver=dpm']
  start = time.time()
  proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                        timeout=600)
  seconds = time.time() - start
  outdir = os.path.join(workdir, 'inpaint-0.5')
  files = sorted(os.listdir(outdir)) if os.path.isdir(outdir) else []
  mse = (float(open(os.path.join(outdir, 'mse.txt')).read())
         if 'mse.txt' in files else None)
  pngs = all(open(os.path.join(outdir, f), 'rb').read(8) == PNG_SIGNATURE
             for f in files if f.endswith('.png'))
  report = dict(returncode=proc.returncode, seconds=seconds, files=files,
                mse=mse, pngs=pngs)
  log(f'  --mode inverse --config.inverse.solver=dpm: exit '
      f'{proc.returncode} in {seconds:.1f} s, files {files}, mse {mse}')
  failures = []
  if (proc.returncode != 0 or files != ['inverse.png', 'mse.txt',
                                        'observation.png']
      or mse is None or not np.isfinite(mse) or not pngs):
    failures.append(f'CLI inverse: {report}; stderr {proc.stderr[-2000:]}')
  return report, failures


NCSNPP_CONFIG = 've/cifar10_ncsnpp_continuous'
HIGHRES_CONFIG = 've/church_ncsnpp_continuous'
# Cuts: the 256^2 config's batch 64 to 8, the PC sampler's N 1000 to 100.
HIGHRES_BATCH = 8
NCSNPP_SAMPLE_STEPS = 100
# The 256^2 config's sites checked forward and backward in f32 and bf16:
# those of its 128^2 and 256^2 levels.
HIGHRES_BIG = 128


def ncsnpp_model(dtype, kernels, seed, name=NCSNPP_CONFIG):
  """NCSN++ at ``name``'s full width in ``dtype``, every parameter
  randomised."""
  return randomized_model(name, dtype, kernels, seed)


def highres_model(dtype, kernels, seed):
  return ncsnpp_model(dtype, kernels, seed, HIGHRES_CONFIG)


def ncsnpp_inputs(config, seed, batch=BATCH):
  """(x in [0, 1], noise levels log-uniform in [sigma_min, sigma_max]):
  the VE model's labels."""
  g = torch.Generator(device='cuda').manual_seed(seed)
  size, ch = config.data.image_size, config.data.num_channels
  x = torch.rand((batch, size, size, ch), generator=g, device='cuda')
  lo = float(np.log(config.model.sigma_min))
  hi = float(np.log(config.model.sigma_max))
  labels = torch.exp(torch.rand((batch,), generator=g, device='cuda')
                     * (hi - lo) + lo)
  return x, labels


def check_site_grads(kind, shape, dtype, seed, batch):
  """K1 (``kind`` 'conv3x3', ``shape`` (H, W, Cin, Cout)) or K2
  ('groupnorm_act', (H, W, C, G), SiLU) at ``batch``: the output and every
  input's gradient against autograd through the plain version, untimed.
  Returns {what: rel error}."""
  g = torch.Generator(device='cuda').manual_seed(seed)
  H, W = shape[:2]
  if kind == 'conv3x3':
    cin, cout = shape[2:]
    args = ((torch.randn((batch, H, W, cin), generator=g, device='cuda')
             .to(dtype)),
            torch.randn((3, 3, cin, cout), generator=g, device='cuda')
            / (9 * cin) ** 0.5,
            0.1 * torch.randn((cout,), generator=g, device='cuda'))
    names, fn, plain = ('y', 'dx', 'dw', 'db'), k1.conv3x3, k1.conv3x3_plain
  else:
    C, G = shape[2:]
    cout = C
    args = ((torch.randn((batch, H, W, C), generator=g, device='cuda') * 2
             + 0.5).to(dtype),
            1 + 0.1 * torch.randn((C,), generator=g, device='cuda'),
            0.1 * torch.randn((C,), generator=g, device='cuda'))
    names = ('y', 'dx', 'dscale', 'dbias')

    def fn(x, scale, bias):
      return k2.groupnorm_act(x, scale, bias, G, 'silu')

    def plain(x, scale, bias):
      return k2.groupnorm_act_plain(x, scale, bias, G, 'silu')
  dy = torch.randn((batch, H, W, cout), generator=g, device='cuda').to(dtype)
  out = []
  for f in (fn, plain):
    leaves = [a.detach().requires_grad_() for a in args]
    y = f(*leaves)
    out.append([y.detach()] + list(torch.autograd.grad(y, leaves, dy)))
    del y, leaves
  errs = {n: rel_err(got, want)[1] for n, got, want in zip(names, *out)}
  del out
  torch.cuda.empty_cache()
  return errs


def fir_calls(model, config, seed, batch):
  """The FIR filters (``upfirdn2d``) of one forward: {(shape, dtype, up,
  down, pad, kernel bytes): (count, kernel)}."""
  calls = {}
  inner = resample.upfirdn2d

  def record(x, kernel, up=1, down=1, pad=(0, 0)):
    k = np.asarray(kernel, np.float32)
    key = (tuple(x.shape), x.dtype, up, down, tuple(pad), k.tobytes())
    calls[key] = (calls.get(key, (0, k))[0] + 1, k)
    return inner(x, kernel, up=up, down=down, pad=pad)

  resample.upfirdn2d = record
  try:
    with torch.inference_mode():
      model(*ncsnpp_inputs(config, seed, batch), train=False)
  finally:
    resample.upfirdn2d = inner
  return calls


def fir_device_ms(calls, seed):
  """Device ms of one forward's FIR filters, alone and with their
  backward (as a train step runs them: both branches of a BigGAN block
  need their gradients): every call in one profiler trace.  (None, None)
  where no trace of them came out complete (a measurement, not a
  check)."""
  g = torch.Generator(device='cuda').manual_seed(seed)
  runs = []
  for (shape, dtype, up, down, pad, _), (count, k) in calls.items():
    x = torch.randn(shape, generator=g, device='cuda').to(dtype)
    y = upfirdn2d_op.upfirdn2d(x, k, up=up, down=down, pad=pad)
    dy = torch.randn(y.shape, generator=g, device='cuda').to(dtype)
    runs.append((x, dy, k, dict(up=up, down=down, pad=pad), count))

  def forward():
    for x, _, k, kw, count in runs:
      for _ in range(count):
        upfirdn2d_op.upfirdn2d(x, k, **kw)

  def both():
    for x, dy, k, kw, count in runs:
      xg = x.detach().requires_grad_()
      for _ in range(count):
        torch.autograd.grad(upfirdn2d_op.upfirdn2d(xg, k, **kw), xg, dy)

  try:
    with torch.inference_mode():
      fwd = device_ms(forward, 3, 1)
    return fwd, device_ms(both, 3, 1)
  except RuntimeError as e:
    log(f'  FIR filters not timed: {e}')
    return None, None


def ncsnpp_kernel_phase(flagship_sites, seed):
  """(a) K1 and K2 against their plain versions at NCSN++'s sites: in bf16
  at batch 8, timed, at every site shape of ``NCSNPP_CONFIG`` and of
  ``HIGHRES_CONFIG`` that the flagship rows do not time; at the 128^2 and
  256^2 sites of ``HIGHRES_CONFIG`` also in f32, and forward and backward
  (K1's data gradient by ``dgrad_phase``, timed in bf16; K2's recomputed
  backward, untimed) in f32 and bf16.  Returns (report, failures)."""
  failures, report = [], {}
  sites = {}
  for name, build in (('ncsnpp', ncsnpp_model), ('highres', highres_model)):
    config, model = build(torch.bfloat16, True, seed)
    conv, norm = site_shapes(model, config, seed, batch=1)
    sites[name] = (conv, norm)
    report[f'{name}_per_forward'] = dict(conv3x3=sum(conv.values()),
                                         groupnorm_act=sum(norm.values()))
    del model
  torch.cuda.empty_cache()
  flag_conv, flag_norm = flagship_sites
  new_conv = collections.Counter()
  new_norm = collections.Counter()
  for conv, norm in sites.values():
    new_conv.update({s: n for s, n in conv.items() if s not in flag_conv})
    new_norm.update({s: n for s, n in norm.items() if s not in flag_norm})
  log(f'  sites a forward: {report}; not timed by the flagship rows: '
      f'{len(new_conv)} K1 and {len(new_norm)} K2 shapes')
  conv_rows, conv_total, _, f1 = kernel_phase(
      'conv3x3', new_conv, check_conv, seed, dtypes=(torch.bfloat16,),
      yardstick=False)
  norm_rows, norm_total, _, f2 = kernel_phase(
      'groupnorm_act', new_norm, check_norm, seed + 100,
      dtypes=(torch.bfloat16,), yardstick=False)
  failures += f1 + f2
  hr_conv, hr_norm = sites['highres']
  big_conv = {s: n for s, n in hr_conv.items() if s[0] >= HIGHRES_BIG}
  big_norm = {s: n for s, n in hr_norm.items() if s[0] >= HIGHRES_BIG}
  grads = []
  for kind, big in (('conv3x3', big_conv), ('groupnorm_act', big_norm)):
    for i, shape in enumerate(sorted(big)):
      for dtype in (torch.float32, torch.bfloat16):
        errs = check_site_grads(kind, shape, dtype, seed + 200 + i,
                                HIGHRES_BATCH)
        name = str(dtype).split('.')[-1]
        row = dict(kind=kind, shape=list(shape), dtype=name,
                   batch=HIGHRES_BATCH, rel_errs=errs, tol=TOL[dtype])
        if kind == 'groupnorm_act':
          row['on_chip'] = k2.groupnorm_plan(
              *shape, torch.tensor([], dtype=dtype).element_size())[
                  'on_chip']
        grads.append(row)
        log(f'  {kind} {shape} {name} batch {HIGHRES_BATCH}, forward and '
            'backward: ' + ', '.join(f'{k} {v:.2e}' for k, v in errs.items())
            + (f' (on chip {row["on_chip"]})' if 'on_chip' in row else ''))
        if not max(errs.values()) <= TOL[dtype]:
          failures.append(f'{kind} {shape} {name}: {errs}')
  dgrad_rows, dgrad_total, f3 = dgrad_phase(big_conv, HIGHRES_BATCH, seed)
  failures += f3
  if (256, 256, 128, 32) not in big_norm:
    failures.append('the 256x256x128 K2 site is missing')
  report.update(conv3x3=conv_rows, groupnorm_act=norm_rows,
                conv3x3_total=conv_total, groupnorm_act_total=norm_total,
                highres_grads=grads, highres_data_grad=dgrad_rows,
                highres_data_grad_total=dgrad_total,
                new_conv_shapes=len(new_conv), new_norm_shapes=len(new_norm))
  return report, failures


def ncsnpp_train_profile(seed):
  """One steady ``NCSNPP_CONFIG`` train step (batch 128, bf16) under the
  profiler, and the device ms of its FIR filters, measured alone at the
  shapes one forward calls them with (forward and backward).  Returns
  (report, failures)."""
  config = configs.get_config(NCSNPP_CONFIG)
  t = config.training
  model = registry.create_model(config, device='cuda', seed=seed)
  tx = losses.get_optimizer(config)
  state = state_lib.create_train_state(dict(model.named_parameters()), tx,
                                       config.model.ema_rate)
  step_fn = losses.get_step_fn(sde_lib.get_sde(config)[0], model, tx,
                               train=True, reduce_mean=t.reduce_mean,
                               continuous=True)
  g = torch.Generator(device='cuda').manual_seed(seed)
  size = config.data.image_size
  batch = torch.rand((t.batch_size, size, size, config.data.num_channels),
                     generator=g, device='cuda') * 2 - 1
  step_fn(state, batch, g)
  out, _ = profiled(f'{NCSNPP_CONFIG} train step (batch {t.batch_size}, '
                    'bf16)', lambda: step_fn(state, batch, g))
  calls = fir_calls(model, config, seed, t.batch_size)
  del state, model
  torch.cuda.empty_cache()
  fwd, both = fir_device_ms(calls, seed)
  busy_ms = out['device_busy_s'] * 1e3
  out.update(fir_calls=sum(n for n, _ in calls.values()),
             fir_shapes=len(calls), fir_forward_ms=fwd, fir_step_ms=both,
             fir_step_share=None if both is None else both / busy_ms)
  if both is not None:
    log(f'  FIR filters: {out["fir_calls"]} calls a forward '
        f'({len(calls)} shapes), {fwd:.3f} device ms forward, {both:.3f} '
        f'with their backward: {out["fir_step_share"]:.3f} of the step\'s '
        f'{busy_ms:.1f} device-busy ms (measured apart from the step)')
  return out, []


def ncsnpp_sample_phase(seed, per_forward):
  """One PC request at ``NCSNPP_CONFIG`` (reverse diffusion + Langevin,
  snr 0.16), batch 8, N = ``NCSNPP_SAMPLE_STEPS`` (cut from 1000), bf16,
  random weights: NFE = 2 N, every evaluation launching the forward's K1
  and K2 sites, samples finite.  Returns (report, failures)."""
  config, model = ncsnpp_model(torch.bfloat16, True, seed)
  config.model.num_scales = NCSNPP_SAMPLE_STEPS
  reset_counts()
  torch.cuda.synchronize()
  start = time.time()
  samples, nfe = run_lib.sample(config, batch_size=BATCH, seed=seed,
                                device='cuda', model=model)
  torch.cuda.synchronize()
  seconds = time.time() - start
  launches = dict(conv3x3=k1.conv3x3.launches,
                  groupnorm_act=k2.groupnorm_act.launches)
  by_kernel = dict(k1.conv3x3.launches_by_kernel)
  finite = bool(torch.isfinite(samples).all())
  per_eval = {k: v / max(nfe, 1) for k, v in launches.items()}
  report = dict(steps=NCSNPP_SAMPLE_STEPS, nfe=nfe, seconds=seconds,
                imgs_per_s=BATCH / seconds, ms_per_evaluation=(
                    1e3 * seconds / max(nfe, 1)),
                launches=launches, per_evaluation=per_eval,
                conv3x3_by_kernel=by_kernel, finite=finite,
                shape=list(samples.shape))
  log(f'  request: {seconds:.2f} s, {BATCH / seconds:.3f} imgs/s, NFE {nfe} '
      f'(N = {NCSNPP_SAMPLE_STEPS}), {report["ms_per_evaluation"]:.2f} ms '
      f'an evaluation; launches {launches} ({per_eval} an evaluation, K1 '
      f'by kernel {by_kernel}); finite {finite}')
  failures = []
  if nfe != 2 * NCSNPP_SAMPLE_STEPS:
    failures.append(f'ncsnpp PC request: NFE {nfe}, expected '
                    f'{2 * NCSNPP_SAMPLE_STEPS}')
  if any(launches[k] != per_forward[k] * nfe for k in launches):
    failures.append(f'ncsnpp PC request launches {launches}, expected '
                    f'{per_forward} x {nfe}')
  if by_kernel['direct'] or not finite:
    failures.append(f'ncsnpp PC request: K1 by kernel {by_kernel}, finite '
                    f'{finite}')
  return report, failures


def ncsnpp_phase(args, flagship_sites):
  """The NCSN++ group (phase 15): (a) K1 and K2 against plain at the new
  site shapes; (b) the full-width forward and a train step's gradients,
  kernel path against plain path, with their launches; (c)
  ``run_lib.train``, one profiled step with the FIR filters' share, one
  PC request; (d) the 256^2 config's forward, kernel path against plain
  path, and ``run_lib.train`` for two steps.  Returns (report,
  failures)."""
  report, failures = {}, []
  log(f'[NCSN++ (a): K1 and K2 vs plain at the {NCSNPP_CONFIG} and '
      f'{HIGHRES_CONFIG} sites the flagship rows do not time (bf16, batch '
      f'{BATCH}); at {HIGHRES_CONFIG}\'s 128^2 and 256^2 sites forward and '
      f'backward in f32 and bf16, batch {HIGHRES_BATCH}]')
  report['kernels'], f = ncsnpp_kernel_phase(flagship_sites, args.seed)
  failures += f
  per_forward = report['kernels']['ncsnpp_per_forward']
  hr_per_forward = report['kernels']['highres_per_forward']
  log(f'[NCSN++ (b): full-width forward, kernel path vs plain path, '
      f'{NCSNPP_CONFIG}, batch {BATCH}, f32 and bf16]')
  report['forward'], f = forward_phase(args.seed, ncsnpp_model,
                                       ncsnpp_inputs, timed=False)
  failures += f
  log(f'[NCSN++ (b): one train step\'s loss and gradients, kernel path vs '
      f'plain path, batch '
      f'{configs.get_config(NCSNPP_CONFIG).training.batch_size}, f32 and '
      f'bf16]')
  report['train_grads'], f = train_grad_phase(args.seed, ncsnpp_model,
                                              bf16_tree=True)
  failures += f
  step = report['train_grads']['bfloat16']['launches']
  want_step = dict(forward=per_forward['conv3x3'],
                   data_grad=per_forward['conv3x3'], jvp=0,
                   groupnorm_act=per_forward['groupnorm_act'])
  for dtype in ('float32', 'bfloat16'):
    got = report['forward'][dtype]['launches']
    if got != per_forward:
      failures.append(f'ncsnpp forward {dtype} launches {got}, expected '
                      f'{per_forward}')
  if step != want_step:
    failures.append(f'ncsnpp train step launches {step}, expected '
                    f'{want_step}')
  log(f'[NCSN++ (c): run_lib.train, {NCSNPP_CONFIG}, bf16, steps '
      f'0..{args.ncsnpp_train_steps}, no snapshot sampling]')
  report['train'], f = nc_train_phase(args.ncsnpp_train_steps, per_forward,
                                      args.seed, NCSNPP_CONFIG)
  failures += f
  log('[NCSN++ (c): one steady train step under torch.profiler; the FIR '
      'filters\' device ms]')
  report['train_profile'], f = ncsnpp_train_profile(args.seed)
  failures += f
  log(f'[NCSN++ (c): one PC request, reverse diffusion + Langevin, batch '
      f'{BATCH}, N = {NCSNPP_SAMPLE_STEPS} (cut from 1000), bf16]')
  report['sample'], f = ncsnpp_sample_phase(args.seed, per_forward)
  failures += f
  log(f'[NCSN++ (d): {HIGHRES_CONFIG} (256^2, output_skip + input_skip), '
      f'batch {HIGHRES_BATCH} (cut from 64): forward kernel path vs plain '
      f'path in bf16, run_lib.train steps 0..1]')
  report['highres_forward'], f = forward_phase(
      args.seed, highres_model, ncsnpp_inputs, dtypes=(torch.bfloat16,),
      batch=HIGHRES_BATCH, timed=False)
  failures += f
  got = report['highres_forward']['bfloat16']['launches']
  if got != hr_per_forward:
    failures.append(f'highres forward launches {got}, expected '
                    f'{hr_per_forward}')
  report['highres_train'], f = nc_train_phase(
      1, hr_per_forward, args.seed, HIGHRES_CONFIG, HIGHRES_BATCH)
  failures += f
  torch.cuda.empty_cache()
  return report, failures


def reset_counts():
  """Every kernel's launch counts to 0."""
  for kernel in (k1.conv3x3, k2.groupnorm_act, k2.groupnorm_act_jvp,
                 k3.correlation, k3.correlation_df1, k3.correlation_df2,
                 k4.ns_step_fused):
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
  number of device kernels and copies, and the top ones, from a complete
  trace of a second call (``traced``: ``fn`` runs once before it in the
  trace's warm-up step, and again where a trace lost device records).
  Returns (the summary, what ``fn`` returned)."""
  prof, host_s, _, result = traced(fn, name)
  ops = device_ops(prof)
  busy_s = sum(e.self_device_time_total for e in ops) * 1e-6
  top = sorted(ops, key=lambda e: -e.self_device_time_total)[:6]
  # Not the profiler's own step range, whose own time is the idle margins.
  host_ops = sorted((e for e in averages(prof)
                     if e.device_type == DeviceType.CPU
                     and not e.key.startswith('ProfilerStep')),
                    key=lambda e: -e.self_cpu_time_total)[:6]
  families = collections.defaultdict(lambda: [0, 0.0])
  for e in ops:
    family = next((f for f, keys in DEVICE_FAMILIES
                   if any(k in e.key for k in keys)), 'other')
    families[family][0] += e.count
    families[family][1] += e.self_device_time_total * 1e-3
  out = dict(host_s=host_s, device_busy_s=busy_s,
             idle_share=1 - busy_s / host_s,
             device_ops=sum(e.count for e in ops),
             families={f: tuple(v) for f, v in sorted(
                 families.items(), key=lambda kv: -kv[1][1])},
             top=[(e.key, e.count, e.self_device_time_total * 1e-3)
                  for e in top],
             top_host=[(e.key, e.count, e.self_cpu_time_total * 1e-3)
                       for e in host_ops])
  log(f'  {name}: host {host_s:.4f} s, device busy {busy_s:.4f} s '
      f'(idle share {out["idle_share"]:.3f}), {out["device_ops"]} device '
      'kernels and copies')
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
  then the vmapped one under ``torch.profiler``, and the filter likewise
  (see ``profiled``).  Returns (report, failures)."""
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
  out['measurement_vmapped'], measurement = profiled(
      'measurement (vmapped draws)', ways['vmapped'])
  out['filter'], _ = profiled('filter', lambda: kf.filter(prep(2, 2),
                                                          measurement))
  return out, failures


# The eval phase's cuts (the whole script is to end within 1200 s):
# eval.batch_size 256, two batches of the 512-image stand-in split (the
# config's 1024 yields none); 128 samples, one round at N = 100.
EVAL_BATCH = 256
EVAL_SAMPLES = 128
EVAL_SAMPLE_STEPS = 100
# bpd of one batch of 8, kernel path against plain path, in f32, at
# rtol = atol = 1e-3 (about a third of the evaluations of the config's
# 1e-5):
# the Dormand-Prince steps may part by ulps (their NFE need not be
# equal), so each image's bpd is held to 1e-3 relative.
BPD_F32_TOL = 1e-3
BPD_F32_ODE_TOL = 1e-3


def jvp_timings(dtype, kernel, plain, library, prev=None):
  """``timings`` in bf16, the main path's dtype, the kernel table's; in
  f32 the forward-mode rows are checked, not timed (NaN)."""
  if dtype == torch.bfloat16:
    return timings(kernel, plain, library, prev)
  keys = ('ms', 'call_ms', 'plain_ms', 'library_ms') + (
      ('prev_ms',) if prev is not None else ())
  return dict.fromkeys(keys, float('nan'))


def check_conv_jvp(shape, dtype, seed, batch=BATCH):
  """K1's forward-mode term at the site (H, W, Cin, Cout): K1 launched on
  the tangent dx, as the likelihood's JVP launches it (no bias), held
  against ``torch.func.jvp`` of the port's conv (the tangent its rule
  gave) and against the plain version on dx; timed beside the plain
  version and ``torch.func.jvp`` of cuDNN ``F.conv2d`` (which computes the
  primal too)."""
  H, W, cin, cout = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  x = torch.randn((batch, H, W, cin), generator=g, device='cuda').to(dtype)
  dx = torch.randn((batch, H, W, cin), generator=g, device='cuda').to(dtype)
  w = (torch.randn((3, 3, cin, cout), generator=g, device='cuda') / (
      9 * cin) ** 0.5).to(dtype)
  b = 0.1 * torch.randn((cout,), generator=g, device='cuda')
  with torch.no_grad():
    _, got = torch.func.jvp(lambda a: k1.conv3x3(a, w, b), (x,), (dx,))
    want = k1.conv3x3_plain(dx, w)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    x_lib, dx_lib = x.permute(0, 3, 1, 2), dx.permute(0, 3, 1, 2)
    w_lib = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b_lib = b.to(dtype)
    row = dict(kernel=k1.kernel_for(dtype, cin, cout), **jvp_timings(
        dtype, lambda: k1._conv(dx, w, None, 'jvp'),
        lambda: k1.conv3x3_plain(dx, w),
        lambda: torch.func.jvp(
            lambda a: F.conv2d(a, w_lib, b_lib, padding=1), (x_lib,),
            (dx_lib,))))
  itemsize = x.element_size()
  flops = 2 * 9 * batch * H * W * cin * cout
  nbytes = (dx.numel() + w.numel() + batch * H * W * cout) * itemsize
  row['bound_ms'], row['bound_by'] = bound(flops, nbytes, dtype)
  row.update(max_abs_err=abs_err, rel_err=rel)
  return row


def check_norm_jvp(shape, dtype, seed, batch=BATCH):
  """The K2 JVP kernel at the site (H, W, C, G), SiLU, a tangent on x:
  ``torch.func.jvp`` through K2 (one K2 and one K2 JVP launch) held
  against ``groupnorm_act_jvp_plain``, and the first card design (on K2's
  cluster plan, the yardstick) too; the kernel alone timed beside the
  yardstick, the plain version and ``torch.func.jvp`` of ``F.group_norm``
  + ``F.silu`` (primal and tangent).  ``on_chip`` is ``jvp_plan``'s (False:
  the output pass streams x and dx again)."""
  H, W, C, G = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  x = (torch.randn((batch, H, W, C), generator=g, device='cuda') * 2 + 0.5
       ).to(dtype)
  dx = torch.randn((batch, H, W, C), generator=g, device='cuda').to(dtype)
  scale = 1 + 0.1 * torch.randn((C,), generator=g, device='cuda')
  bias = 0.1 * torch.randn((C,), generator=g, device='cuda')
  with torch.no_grad():
    _, got = torch.func.jvp(
        lambda a: k2.groupnorm_act(a, scale, bias, G, 'silu'), (x,), (dx,))
    again = k2.groupnorm_act_jvp(x, dx, scale, bias, None, None, G, 'silu')
    old = k2._groupnorm_act_jvp_cluster(x, dx, scale, bias, None, None, G,
                                        'silu')
    want = k2.groupnorm_act_jvp_plain(x, dx, scale, bias, None, None, G,
                                      'silu')
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    prev_abs, prev_rel = rel_err(old, want)
    x_lib, dx_lib = x.permute(0, 3, 1, 2), dx.permute(0, 3, 1, 2)
    s_lib, b_lib = scale.to(dtype), bias.to(dtype)
    row = jvp_timings(
        dtype, lambda: k2.groupnorm_act_jvp(x, dx, scale, bias, None, None,
                                            G, 'silu'),
        lambda: k2.groupnorm_act_jvp_plain(x, dx, scale, bias, None, None, G,
                                           'silu'),
        lambda: torch.func.jvp(
            lambda a: F.silu(F.group_norm(a, G, s_lib, b_lib, 1e-6)),
            (x_lib,), (dx_lib,)),
        prev=lambda: k2._groupnorm_act_jvp_cluster(x, dx, scale, bias, None,
                                                   None, G, 'silu'))
  plan = k2.jvp_plan(H, W, C, G, x.element_size(), batch)
  row.update(on_chip=plan['on_chip'], cluster=plan['cluster'],
             blocks=plan['blocks'], stages=plan['stages'],
             smem_bytes=plan['smem_bytes'],
             same_bits_twice=bool(torch.equal(got, again)))
  n = x.numel()
  nbytes = 3 * n * x.element_size() + 8 * C
  row['bound_ms'], row['bound_by'] = bound(25 * n, nbytes, dtype)
  row.update(max_abs_err=abs_err, rel_err=rel, prev_abs_err=prev_abs,
             prev_rel_err=prev_rel)
  return row


def eval_counts():
  uses = k1.conv3x3.launches_by_use
  return {'conv3x3': uses['forward'], 'conv3x3_jvp': uses['jvp'],
          'conv3x3_data_grad': uses['data_grad'],
          'groupnorm_act': k2.groupnorm_act.launches,
          'groupnorm_act_jvp': k2.groupnorm_act_jvp.launches}


def drift_div_fn_of(config, model, params=None, functorch=False):
  """The likelihood's drift-and-divergence (one forward-mode pass) of
  ``model`` under ``params`` (default its own), parameters detached; with
  ``functorch``, the same by ``torch.func.jvp`` (the yardstick the
  likelihood's ``forward_ad`` pass is timed against)."""
  sde, _ = sde_lib.get_sde(config)
  params = dict(model.named_parameters()) if params is None else params
  score_fn = registry.get_score_fn(
      sde, model, train=False, continuous=True,
      params={k: v.detach() for k, v in params.items()})
  rsde = sde.reverse(score_fn, probability_flow=True)
  if not functorch:
    return likelihood.get_drift_div_fn(lambda a, t: rsde.sde(a, t)[0])

  def drift_div(x, t, eps):
    drift, tangent = torch.func.jvp(lambda a: rsde.sde(a, t)[0], (x,),
                                    (eps,))
    return drift, (tangent * eps).reshape(x.shape[0], -1).sum(-1)
  return drift_div


def rademacher(shape, seed):
  g = torch.Generator(device='cuda').manual_seed(seed)
  return torch.randint(0, 2, shape, generator=g, device='cuda').float() * 2 - 1


def drift_div_phase(per_forward, seed):
  """One drift-plus-divergence evaluation of the likelihood at the
  flagship's full width, batch 8, every parameter randomised, kernel path
  against plain path on the same x, t and probe, in f32 (TF32 off) and
  bf16, with the launches counted over it.  Returns (report, per-evaluation
  launches of the bf16 kernel path, failures)."""
  out, failures, per_eval = {}, [], None
  want = {'conv3x3': per_forward['conv3x3'],
          'conv3x3_jvp': per_forward['conv3x3'], 'conv3x3_data_grad': 0,
          'groupnorm_act': per_forward['groupnorm_act'],
          'groupnorm_act_jvp': per_forward['groupnorm_act']}
  for dtype in (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    config, kernel_model = flagship(dtype, True, seed)
    _, plain_model = flagship(dtype, False, seed)
    x, _ = model_inputs(config, seed)
    eps = rademacher(x.shape, seed + 1)
    t = torch.full((BATCH,), 0.5, device='cuda')
    results = {}
    with torch.no_grad():
      for path, model in (('kernel', kernel_model), ('plain', plain_model)):
        fn = drift_div_fn_of(config, model)
        reset_counts()
        drift, div = fn(x, t, eps)
        torch.cuda.synchronize()
        results[path] = (drift, div, eval_counts(),
                         time_ms(lambda: fn(x, t, eps), 3, 1))
    (k_drift, k_div, k_counts, k_ms), (p_drift, p_div, p_counts, p_ms) = (
        results['kernel'], results['plain'])
    errs = {'drift': rel_err(k_drift, p_drift)[1],
            'div': rel_err(k_div, p_div)[1]}
    finite = bool(torch.isfinite(k_drift).all() and torch.isfinite(k_div)
                  .all())
    out[name] = dict(rel_err=errs, tol=TOL[dtype], kernel_counts=k_counts,
                     plain_counts=p_counts, kernel_eval_ms=k_ms,
                     plain_eval_ms=p_ms)
    log(f'  drift + divergence {name}, batch {BATCH}: drift rel '
        f'{errs["drift"]:.3e}, divergence rel {errs["div"]:.3e} (limit '
        f'{TOL[dtype]}); kernel path {k_ms:.2f} ms, plain path {p_ms:.2f} '
        f'ms an evaluation (host clock); launches {k_counts}')
    if not (finite and max(errs.values()) <= TOL[dtype]):
      failures.append(f'drift + divergence {name}: {errs}, finite {finite}')
    if k_counts != want:
      failures.append(f'drift + divergence {name}: launches {k_counts}, '
                      f'expected {want}')
    if any(p_counts.values()):
      failures.append(f'drift + divergence {name}: the plain path launched '
                      f'{p_counts}')
    if dtype == torch.bfloat16:
      per_eval = k_counts
    del kernel_model, plain_model, results
    torch.cuda.empty_cache()
  return out, per_eval, failures


def eval_config():
  """The flagship config for ``run_lib.evaluate`` on the train phase's
  checkpoint, with this script's cuts: ``eval.batch_size`` ``EVAL_BATCH``
  (the config's 1024 yields no batch of the 512-image stand-in split),
  ``bpd_dataset`` 'train' (one repeat over the batches), and
  ``num_samples`` 128 at N = 100 (``model.num_scales`` moves only the
  sampler: the continuous model's labels are t * 999)."""
  config = configs.get_config(CONFIG)
  ev = config.eval
  ev.begin_ckpt = ev.end_ckpt = 1
  ev.batch_size = EVAL_BATCH
  ev.enable_loss = ev.enable_bpd = ev.enable_sampling = True
  ev.bpd_dataset = 'train'
  ev.num_samples = EVAL_SAMPLES
  config.model.num_scales = EVAL_SAMPLE_STEPS
  return config


def eval_phase(train_dir, per_forward, seed):
  """``run_lib.evaluate`` (loss, bpd, samples and FID/KID/IS) on the
  checkpoint that the train phase wrote, bf16, with the launch counts set
  to 0 before and read after; one bpd evaluation at ``EVAL_BATCH`` under the
  profiler; one batch of 8's bpd kernel path against plain path in f32.
  Returns (report, failures)."""
  config = eval_config()
  failures, history = [], []
  reset_counts()
  torch.cuda.reset_peak_memory_stats()
  torch.cuda.synchronize()
  start = time.time()
  results = run_lib.evaluate(config, train_dir, 'eval', device='cuda',
                             history=history)
  torch.cuda.synchronize()
  total_s = time.time() - start
  peak = torch.cuda.max_memory_allocated()
  counts = eval_counts()
  eval_dir = os.path.join(train_dir, 'eval')
  files = sorted(os.path.relpath(os.path.join(d, f), eval_dir)
                 for d, _, fs in os.walk(eval_dir) for f in fs)
  bpd_runs = [h for h in history if h['kind'] == 'bpd']
  sample_runs = [h for h in history if h['kind'] == 'sample']
  nfe = sum(h['nfe'] for h in bpd_runs)
  loss_batches = 512 // EVAL_BATCH
  forwards = nfe + loss_batches + len(sample_runs) * EVAL_SAMPLE_STEPS
  want = {'conv3x3': per_forward['conv3x3'] * forwards,
          'conv3x3_jvp': per_forward['conv3x3'] * nfe,
          'conv3x3_data_grad': 0,
          'groupnorm_act': per_forward['groupnorm_act'] * forwards,
          'groupnorm_act_jvp': per_forward['groupnorm_act'] * nfe}
  metrics = {k: results.get(f'ckpt_1_{k}') for k in (
      'loss', 'bpd', 'fid', 'kid', 'inception_score')}
  report = dict(
      seconds=total_s, results=results, max_memory_allocated=peak,
      launches=counts, expected_launches=want, files=files,
      bpd_batches=[dict(nfe=h['nfe'], seconds=h['seconds'])
                   for h in bpd_runs],
      sample_rounds=[dict(nfe=h['nfe'], seconds=h['seconds'])
                     for h in sample_runs])
  log(f'  evaluate: {total_s:.1f} s; loss {metrics["loss"]}, bpd '
      f'{metrics["bpd"]}, FID {metrics["fid"]}, KID {metrics["kid"]}, IS '
      f'{metrics["inception_score"]} (features: '
      f'{results.get("feature_source")}); peak memory '
      f'{peak / 2**30:.2f} GiB')
  log(f'  bpd batches (batch {EVAL_BATCH}): ' + ', '.join(
      f'nfe {h["nfe"]} in {h["seconds"]:.2f} s ('
      f'{1e3 * h["seconds"] / h["nfe"]:.1f} ms an evaluation)'
      for h in bpd_runs))
  log(f'  sampling rounds (batch {EVAL_BATCH}, N = {EVAL_SAMPLE_STEPS}): '
      + ', '.join(
      f'{h["seconds"]:.2f} s' for h in sample_runs))
  log(f'  launches {counts} (expected {want}); files {files}')
  if not all(v is not None and np.isfinite(v) for v in metrics.values()):
    failures.append(f'evaluate: results {results}')
  if counts != want:
    failures.append(f'evaluate: launches {counts}, expected {want}')
  if len(bpd_runs) != loss_batches or len(sample_runs) != (
      EVAL_SAMPLES // EVAL_BATCH + 1):
    failures.append(f'evaluate: {len(bpd_runs)} bpd batches, '
                    f'{len(sample_runs)} sampling rounds')
  for name in ('ckpt_1_loss.npz', 'train_ckpt_1_bpd.npz', 'report_1.npz',
               os.path.join('ckpt_1', 'samples_0.npz')):
    if name not in files:
      failures.append(f'evaluate: {name} not written ({files})')

  # One bpd evaluation of the checkpoint at EVAL_BATCH, profiled.
  template, model = run_lib._template(config, torch.device('cuda'), seed)
  state = ckpt_lib.restore_checkpoint(
      os.path.join(train_dir, 'checkpoints', 'checkpoint_1'), template)
  _, eval_ds = get_dataset(config, evaluation=True)
  batch = torch.from_numpy(get_data_scaler(config)(
      next(iter(eval_ds))[0])).cuda()
  fn = drift_div_fn_of(config, model, state.ema_params)
  eps = rademacher(batch.shape, seed)
  t = torch.full((EVAL_BATCH,), 0.5, device='cuda')
  with torch.no_grad():
    fn(batch, t, eps)
    report['profile'], (drift, div) = profiled(
        f'bpd evaluation (drift + divergence, batch {EVAL_BATCH}, bf16)',
        lambda: fn(batch, t, eps))
    # The same evaluation by torch.func.jvp, in turns with forward_ad.
    by_func = drift_div_fn_of(config, model, state.ema_params,
                              functorch=True)
    f_drift, f_div = by_func(batch, t, eps)
    ms = {'forward_ad': [], 'func_jvp': []}
    for _ in range(2):
      ms['forward_ad'].append(time_ms(lambda: fn(batch, t, eps), 3, 1))
      ms['func_jvp'].append(time_ms(lambda: by_func(batch, t, eps), 3, 1))
  report['evaluation_ms'] = ms
  same = (rel_err(f_drift, drift)[1], rel_err(f_div, div)[1])
  log(f'  one evaluation at batch {EVAL_BATCH} (host clock, in turns): '
      f'forward_ad {ms["forward_ad"]} ms, torch.func.jvp {ms["func_jvp"]} '
      f'ms; the two agree to {same[0]:.2e} (drift), {same[1]:.2e} '
      '(divergence)')
  if not max(same) <= TOL[torch.bfloat16]:
    failures.append(f'forward_ad vs torch.func.jvp: {same}')

  # bpd of 8 images, kernel path against plain path, in f32.
  bpds = {}
  for kernels in (True, False):
    f32 = eval_config()
    f32.tpu.compute_dtype = 'float32'
    model = registry.create_model(f32, device='cuda', seed=seed,
                                  kernels=kernels)
    fn = likelihood.get_likelihood_fn(
        sde_lib.get_sde(f32)[0], model, get_data_inverse_scaler(f32),
        rtol=BPD_F32_ODE_TOL, atol=BPD_F32_ODE_TOL)
    start = time.time()
    bpd, _, nfe = fn(state.ema_params, batch[:8],
                     torch.Generator(device='cuda').manual_seed(seed))
    torch.cuda.synchronize()
    bpds[kernels] = (bpd, nfe, time.time() - start)
  rel = float(((bpds[True][0] - bpds[False][0]).abs()
               / bpds[False][0].abs()).max())
  report['f32_bpd'] = dict(kernel=bpds[True][0].tolist(),
                           plain=bpds[False][0].tolist(),
                           kernel_nfe=bpds[True][1], plain_nfe=bpds[False][1],
                           kernel_s=bpds[True][2], plain_s=bpds[False][2],
                           max_rel=rel, tol=BPD_F32_TOL)
  log(f'  bpd of 8 images in f32 (rtol = atol = {BPD_F32_ODE_TOL}): kernel '
      f'path nfe {bpds[True][1]} '
      f'({bpds[True][2]:.1f} s), plain path nfe {bpds[False][1]} '
      f'({bpds[False][2]:.1f} s); max rel difference {rel:.3e} (limit '
      f'{BPD_F32_TOL})')
  if not rel <= BPD_F32_TOL:
    failures.append(f'f32 bpd kernel vs plain: {report["f32_bpd"]}')
  return report, failures


def eval_cli_phase(train_dir, workdir):
  """``python -m b_pinn_kalman_filter_tpu_torch --mode sample --ckptdir
  <the train phase's checkpoint>`` (batch 8, N = 100) and ``--mode eval``
  (the loss alone, the config's default, of ``checkpoint_1`` at
  ``eval.batch_size`` 128) as subprocesses.  Returns (report,
  failures)."""
  root = os.path.dirname(os.path.abspath(__file__))
  config_file = os.path.join(root, 'b_pinn_kalman_filter_tpu_torch',
                             'configs', *CONFIG.split('/')) + '.py'
  ckpt = os.path.join(train_dir, 'checkpoints', 'checkpoint_1')
  runs = {
      'sample': ['--workdir', workdir, '--ckptdir', ckpt,
                 f'--config.training.batch_size={BATCH}',
                 f'--config.model.num_scales={EVAL_SAMPLE_STEPS}'],
      'eval': ['--workdir', train_dir, '--eval_folder', 'cli_eval',
               '--config.eval.begin_ckpt=1', '--config.eval.end_ckpt=1',
               f'--config.eval.batch_size={EVAL_BATCH}']}
  report, failures = {}, []
  for mode, args in runs.items():
    start = time.time()
    proc = subprocess.run(
        [sys.executable, '-m', 'b_pinn_kalman_filter_tpu_torch', '--config',
         config_file, '--mode', mode, *args], cwd=root, capture_output=True,
        text=True, timeout=600)
    seconds = time.time() - start
    if mode == 'sample':
      png = os.path.join(workdir, 'sample.png')
      ok = (os.path.exists(png)
            and open(png, 'rb').read(8) == PNG_SIGNATURE)
      detail = {'sample.png': ok}
    else:
      path = os.path.join(train_dir, 'cli_eval', 'ckpt_1_loss.npz')
      loss = (float(np.load(path)['mean_loss']) if os.path.exists(path)
              else None)
      ok = loss is not None and np.isfinite(loss)
      detail = {'mean_loss': loss}
    report[mode] = dict(returncode=proc.returncode, seconds=seconds,
                        **detail)
    log(f'  --mode {mode}: exit {proc.returncode} in {seconds:.1f} s, '
        f'{detail}')
    if proc.returncode != 0 or not ok:
      failures.append(f'CLI {mode}: {report[mode]}; stderr '
                      f'{proc.stderr[-2000:]}')
  return report, failures


def forward_phase(seed, build=None, inputs=None, dtypes=None, batch=BATCH,
                  timed=True):
  """Full-width forward, every parameter randomised: kernels vs plain, of
  the flagship (or of ``build(dtype, kernels, seed)``'s model on
  ``inputs(config, seed, batch)``), in f32 and bf16 (or ``dtypes``), with
  the kernel path's launches in its last dtype; each path's forward ms on
  the host's clock and, with ``timed``, in device time (a profiler trace
  of a few forwards)."""
  out, failures = {}, []
  build, inputs = build or flagship, inputs or model_inputs
  for dtype in dtypes or (torch.float32, torch.bfloat16):
    config, kernel_model = build(dtype, True, seed)
    _, plain_model = build(dtype, False, seed)
    x, labels = inputs(config, seed, batch)
    with torch.inference_mode():
      reset_counts()
      got = kernel_model(x, labels, train=False)
      torch.cuda.synchronize()
      launches = dict(conv3x3=k1.conv3x3.launches,
                      groupnorm_act=k2.groupnorm_act.launches)
      want = plain_model(x, labels, train=False)
      torch.cuda.synchronize()
      abs_err, rel = rel_err(got, want)
      finite = bool(torch.isfinite(got).all())
      ms = {}
      for path, net in (('kernel', kernel_model), ('plain', plain_model)):
        ms[path] = time_ms(lambda: net(x, labels, train=False), 5, 1)
        ms[path + '_device'] = (device_ms(
            lambda: net(x, labels, train=False), 3, 1) if timed
            else float('nan'))
    name = str(dtype).split('.')[-1]
    out[name] = dict(max_abs_err=abs_err, rel_err=rel, tol=TOL[dtype],
                     max_abs_out=float(want.abs().max()),
                     kernel_forward_ms=ms['kernel'],
                     plain_forward_ms=ms['plain'],
                     kernel_forward_device_ms=ms['kernel_device'],
                     plain_forward_device_ms=ms['plain_device'],
                     launches=launches)
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
  parser.add_argument('--requests', type=int, default=1,
                      help='sample requests (default 1)')
  parser.add_argument('--cycles', type=int, default=10,
                      help='ukf filter cycles (default 10, as ukf_lib.run)')
  parser.add_argument('--train-steps', type=int, default=10,
                      help='train steps after step 0 (default 10; even)')
  parser.add_argument('--prelim-steps', type=int, default=10,
                      help='PINN prelim steps after step 0 (default 10; '
                      'even)')
  parser.add_argument('--pinn-steps', type=int, default=4,
                      help='PINN phase-2 steps after its first (default '
                      '4; even)')
  parser.add_argument('--bpinn-steps', type=int, default=6,
                      help='B-PINN steps after step 0 (default 6; even)')
  parser.add_argument('--fixed-steps', type=int, default=10,
                      help='DPS fixed-solver steps (default 10 of the '
                      'reference\'s 5000)')
  parser.add_argument('--lfn-pinn-steps', type=int, default=4,
                      help='LiteFlowNet-PINN phase-2 steps after its first '
                      '(default 4; even)')
  parser.add_argument('--lfn-bpinn-steps', type=int, default=4,
                      help='LiteFlowNet B-PINN steps after step 0 (default '
                      '4; even)')
  parser.add_argument('--nc-train-steps', type=int, default=4,
                      help='vp/nc_ddpmpp DDPM train steps after step 0 '
                      '(default 4)')
  parser.add_argument('--ncsnpp-train-steps', type=int, default=4,
                      help=f'{NCSNPP_CONFIG} train steps after step 0 '
                      '(default 4)')
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
  snapshot_steps = min(steps, SNAPSHOT_STEPS)
  log(f'[train: run_lib.train, {CONFIG}, batch {train_batch}, bf16, steps '
      f'0..{args.train_steps}, snapshot sampling at N={snapshot_steps}; '
      f'then a resume]')
  # The train run's workdir: the eval phase evaluates its checkpoint.
  train_tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_train_')
  report['train'], train_launches, f9 = train_phase(
      snapshot_steps, args.train_steps, per_forward, args.seed,
      train_tmp.name)
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

  report['bpinn'], f16 = bpinn_phase(args.bpinn_steps, args.seed)
  failures += f16

  report['lfn'], f16b = lfn_phase(args)
  failures += f16b

  nc_config, nc = nc_model(torch.bfloat16, True, args.seed)
  nc_batch = nc_config.training.batch_size
  log(f'[inverse: K1, K1 dx and K2 vs plain at the {INVERSE_CONFIG} U-Net '
      f'sites, batch {nc_batch}, f32 and bf16]')
  nc_conv_sites, nc_norm_sites = site_shapes(nc, nc_config, args.seed,
                                             nc_batch)
  del nc
  nc_per_forward = {'conv3x3': sum(nc_conv_sites.values()),
                    'groupnorm_act': sum(nc_norm_sites.values())}
  log(f'  sites per forward: {nc_per_forward}')
  nc_conv_rows, nc_conv_total, nc_conv_more, f17 = kernel_phase(
      'conv3x3', nc_conv_sites, check_conv, args.seed, batch=nc_batch,
      yardstick=False)
  nc_norm_rows, nc_norm_total, _, f18 = kernel_phase(
      'groupnorm_act', nc_norm_sites, check_norm, args.seed, batch=nc_batch,
      yardstick=False)
  nc_dgrad_rows, nc_dgrad_total, f19 = dgrad_phase(nc_conv_sites, nc_batch,
                                                   args.seed)
  failures += f17 + f18 + f19
  report['kernels']['inverse'] = dict(conv3x3=nc_conv_rows,
                                      groupnorm_act=nc_norm_rows,
                                      conv3x3_data_grad=nc_dgrad_rows)
  # K1 at the NC U-Net's 64x64 level on its own (TMA box (1, 1, 64)), in
  # bf16: the baseline a redesign of K1 at these shapes is held to.
  nc64 = [r for r in nc_conv_rows
          if r['dtype'] == 'bfloat16' and r['shape'][0] == 64]
  k1_nc64 = dict({k: v for k, v in nc_conv_more['levels'][64].items()
                  if k != 'prev_ms'},
                 boxes=sorted({tuple(r['box']) for r in nc64}),
                 plain_ms=sum(r['plain_ms'] * r['per_forward'] for r in nc64),
                 shapes=[{k: r[k] for k in (
                     'shape', 'per_forward', 'ms', 'plain_ms', 'library_ms',
                     'bound_ms')} for r in nc64])
  log(f'  K1 at 64x64 (boxes {k1_nc64["boxes"]}), {k1_nc64["sites"]} sites '
      f'a forward: kernel {k1_nc64["ms"]:.4f} ms, library '
      f'{k1_nc64["library_ms"]:.4f}, bound {k1_nc64["bound_ms"]:.4f}')
  reread = [r for r in nc_norm_rows if not r['on_chip']]
  log('  K2 re-read branch (on_chip False) at '
      + ', '.join(f'{r["shape"][:3]} {r["dtype"]} rel {r["rel_err"]:.2e}'
                  for r in reread))
  # The site the issue of the re-read branch names: 64x64x128 in f32.
  reread_f32 = [r for r in reread if r['dtype'] == 'float32'
                and r['shape'][:3] == [64, 64, 128]]
  if len(reread_f32) != 1:
    failures.append('groupnorm_act: the 64x64x128 f32 site did not take '
                    'the re-read branch')
  log(f'[inverse: one DPS guided evaluation, kernel path vs plain path, '
      f'batch {nc_batch}, f32 and bf16]')
  report['inverse_guided'], per_eval, f20 = guided_eval_phase(args.seed)
  failures += f20
  want_eval = dict(conv3x3=nc_per_forward['conv3x3'],
                   conv3x3_data_grad=nc_per_forward['conv3x3'],
                   groupnorm_act=nc_per_forward['groupnorm_act'])
  if per_eval != want_eval:
    failures.append(f'guided eval launches {per_eval}, expected {want_eval}')
  log(f'[train: run_lib.train, {NC_TRAIN_CONFIG} through the DDPM loss, '
      f'batch {configs.get_config(NC_TRAIN_CONFIG).training.batch_size}, '
      f'bf16, steps '
      f'0..{args.nc_train_steps}]')
  report['nc_train'], f20b = nc_train_phase(args.nc_train_steps,
                                            nc_per_forward, args.seed)
  failures += f20b
  log(f'[inverse: inverse_lib.inverse (dpm), the controlled sampler (RK45), '
      f'DPS (fixed, {args.fixed_steps} steps); batch {nc_batch}, bf16]')
  report['inverse'], f21 = inverse_phase(args.fixed_steps, per_eval,
                                         args.seed)
  failures += f21
  log(f'[sample: run_lib.sample, {CONFIG}, dpm_solver, batch {BATCH}]')
  report['dpm_sample'], f22 = dpm_sample_phase(model, per_forward, args.seed)
  failures += f22
  log('[inverse: the CLI, --mode inverse]')
  with tempfile.TemporaryDirectory() as tmp:
    report['inverse_cli'], f23 = inverse_cli_phase(os.path.join(tmp, 'cli'))
  failures += f23

  log(f'[eval: K1 and K2 forward mode (K1 on the tangent, the K2 JVP '
      f'kernel) vs plain at the main-path shapes, batch {BATCH}, f32 and '
      f'bf16]')
  jvp_conv_rows, jvp_conv_total, jvp_conv_more, f24 = kernel_phase(
      'conv3x3 jvp', conv_sites, check_conv_jvp, args.seed)
  jvp_norm_rows, jvp_norm_total, jvp_norm_more, f25 = kernel_phase(
      'groupnorm_act jvp', norm_sites, check_norm_jvp, args.seed)
  failures += f24 + f25
  log(f'[eval: the K2 JVP kernel vs plain at the main-path shapes, batch '
      f'{EVAL_BATCH} (the bits/dim batch), f32 and bf16]')
  jvp_b256_rows, jvp_b256_total, jvp_b256_more, f25b = kernel_phase(
      'groupnorm_act jvp', norm_sites, check_norm_jvp, args.seed + 50,
      batch=EVAL_BATCH)
  failures += f25b
  report['kernels'].update(conv3x3_jvp=jvp_conv_rows,
                           groupnorm_act_jvp=jvp_norm_rows,
                           groupnorm_act_jvp_b256=jvp_b256_rows)
  log(f'[eval: one drift + divergence evaluation of the likelihood, kernel '
      f'path vs plain path, batch {BATCH}, f32 and bf16]')
  report['drift_div'], per_eval_bpd, f26 = drift_div_phase(per_forward,
                                                           args.seed)
  failures += f26
  log(f'[eval: run_lib.evaluate on the train phase\'s checkpoint_1, bf16: '
      f'loss, bpd (batch {EVAL_BATCH}, bpd_dataset train), '
      f'{EVAL_SAMPLES} samples at N={EVAL_SAMPLE_STEPS} and FID/KID/IS]')
  report['eval'], f27 = eval_phase(train_tmp.name, per_forward, args.seed)
  failures += f27
  log('[eval: the CLI, --mode sample and --mode eval]')
  with tempfile.TemporaryDirectory() as tmp:
    report['eval_cli'], f28 = eval_cli_phase(train_tmp.name,
                                             os.path.join(tmp, 'sample'))
  failures += f28
  train_tmp.cleanup()

  report['ncsnpp'], f29 = ncsnpp_phase(args, (conv_sites, norm_sites))
  failures += f29
  eval_launches = report['eval']['launches']
  dps_launches = report['inverse']['dps_dpm']['launches']

  def dps_keys(total, launches_key):
    """A kernel's numbers a DPS guided evaluation at the NC sites (batch
    16, bf16): launches an evaluation and over the ``dpm`` request, and
    the device ms, plain ms, library ms and bound of one evaluation's
    launches."""
    return dict(dps_eval_launches=per_eval[launches_key],
                dps_request_launches=dps_launches[launches_key],
                **{f'dps_eval_{k}': total[k] for k in (
                    'ms', 'plain_ms', 'library_ms', 'bound_ms')})
  bpinn_train = report['bpinn']['train']
  bpinn_step = report['bpinn']['grads']['step_launches']
  # The bounds of K3 and of B1 + B2 a step at the five level shapes at
  # batch 64: once a level a B-PINN (and prelim) step, 30 times a phase-2
  # step.
  size = config.data.image_size
  k3_step_bound = sum(corr_bound((prelim_batch_size, size >> (i + 1),
                                  size >> (i + 1), c))[0]
                      for i, c in enumerate(config.model.feature_nums))
  bwd_step_bound = bwd_total['bound_ms']
  per_level = step_launches['correlation'] // len(config.model.feature_nums)

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
  nc_train = report['nc_train']
  lfn = report['lfn']
  lfn_totals = lfn['kernel_totals']
  lfn_bpinn = lfn['bpinn']['train']

  def lfn_keys(kernels, which):
    """K3's (``which`` 'k3') or B1 + B2's ('k3_bwd') numbers on the
    LiteFlowNet-PINN path (pinn/pinn_pde_lfn, batch 64, f32): launches a
    forward (K3), a prelim, phase-2 and B-PINN step and a ukf cycle, and
    over the phase-2 and B-PINN runs; device ms of the kernel-table
    shapes and in the profiled steps, with the bounds."""
    def n(counts):
      return sum(counts[k] for k in kernels)
    out = dict(
        lfn_prelim_step_launches=n(lfn['prelim_grads']['step_launches']),
        lfn_phase2_step_launches=n(lfn['pinn_grads']['step_launches']),
        lfn_phase2_step_launches_by_size={
            k: lfn['pinn_grads']['step_launches_by_size'][k]
            for k in kernels},
        lfn_phase2_launches=n(lfn['pinn_launches']),
        lfn_bpinn_step_launches=n(lfn['bpinn']['grads']['step_launches']),
        lfn_bpinn_launches=n(lfn_bpinn['launches']),
        lfn_phase2_step_device_ms=lfn['pinn'][f'{which}_device_ms'])
    if which == 'k3':
      out.update(
          lfn_forward_launches=lfn['forward']['k3_launches'],
          lfn_ukf_cycle_launches=lfn['bpinn']['ukf']['launches'][
              'correlation'] // lfn['bpinn']['ukf']['cycles'],
          **{f'lfn_forward_{k}': lfn_totals['forward'][k]
             for k in ('ms', 'plain_ms', 'bound_ms')},
          **{f'lfn_cycle_{k}': lfn_totals['cycle'][k]
             for k in ('ms', 'plain_ms', 'bound_ms')})
    else:
      out.update({f'lfn_prelim_step_{k}': lfn_totals['prelim_step_bwd'][k]
                  for k in ('ms', 'plain_ms', 'bound_ms')})
    return out

  pp = report['ncsnpp']
  pp_kernels = pp['kernels']

  def ncsnpp_keys(kind):
    """A kernel's numbers on the NCSN++ paths (``kind`` 'forward' and
    'data_grad' for K1, 'groupnorm_act' for K2): launches a forward, a
    train step, a PC evaluation and over the train and PC runs at
    ``NCSNPP_CONFIG`` (batch 128 and 8, bf16), a forward at
    ``HIGHRES_CONFIG`` and over its two train steps (batch 8); device ms
    of the site shapes the flagship rows do not time (bf16, batch 8, one
    forward's count of each) and, for K1's data gradient, of the 256^2
    config's 128^2 and 256^2 sites (batch 8)."""
    per = pp_kernels['ncsnpp_per_forward']
    hr = pp_kernels['highres_per_forward']
    if kind == 'groupnorm_act':
      run = lambda r: r['launches']['groupnorm_act']
      key, step = 'groupnorm_act', pp['train_grads']['bfloat16'][
          'launches']['groupnorm_act']
    else:
      run = lambda r: r['launches']['conv3x3'][kind]
      key, step = 'conv3x3', pp['train_grads']['bfloat16']['launches'][kind]
    out = dict(ncsnpp_train_step_launches=step,
               ncsnpp_train_launches=run(pp['train']),
               highres_train_launches=run(pp['highres_train']))
    if kind != 'data_grad':
      out.update(
          ncsnpp_forward_launches=per[key], highres_forward_launches=hr[key],
          ncsnpp_pc_evaluation_launches=pp['sample']['per_evaluation'][key],
          ncsnpp_pc_request_launches=pp['sample']['launches'][key])
      total = pp_kernels[f'{key}_total']
      out.update({f'ncsnpp_new_sites_{k}': total[k] for k in (
          'ms', 'plain_ms', 'library_ms', 'bound_ms')})
    else:
      total = pp_kernels['highres_data_grad_total']
      out.update({f'highres_big_sites_{k}': total[k] for k in (
          'ms', 'plain_ms', 'library_ms', 'bound_ms')})
    return out

  def nc_keys(use):
    """A kernel's launches in ``vp/nc_ddpmpp``'s DDPM training (batch
    64, bf16): a step's and over the run."""
    launches = (nc_train['launches']['conv3x3'][use] if use else
                nc_train['launches']['groupnorm_act'])
    per = nc_train['per_step']['conv3x3' if use else 'groupnorm_act']
    return dict(nc_train_step_launches=per, nc_train_launches=launches)

  reread_row = reread_f32[0] if reread_f32 else {}
  table = {'kernels': [
      dict(entry('conv3x3', 'conv3x3_wgmma.cu', 'winograd_pallas.py:159',
                 by_kernel['wgmma'], conv_all),
           **dps_keys(nc_conv_total, 'conv3x3'),
           dps_eval_64x64=k1_nc64, **nc_keys('forward'),
           **ncsnpp_keys('forward')),
      entry('conv3x3_direct', 'conv3x3.cu', 'winograd_pallas.py:159',
            by_kernel['direct'], conv_all, yardstick=True),
      dict(entry('conv3x3_data_grad', 'conv3x3_wgmma.cu',
                 'winograd_pallas.py:159',
                 report['train']['conv3x3_by_use']['data_grad'],
                 dgrad_total),
           **dps_keys(nc_dgrad_total, 'conv3x3_data_grad'),
           **nc_keys('data_grad'), **ncsnpp_keys('data_grad')),
      dict(entry('groupnorm_act', 'groupnorm.cu', 'groupnorm_pallas.py:118',
                 launches['groupnorm_act'], norm_all),
           **dps_keys(nc_norm_total, 'groupnorm_act'),
           reread_f32_64x64x128={k: reread_row.get(k) for k in (
               'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
               'rel_err')}, **nc_keys(None),
           **ncsnpp_keys('groupnorm_act')),
      dict(entry('conv3x3_jvp', 'conv3x3_wgmma.cu', 'winograd_pallas.py:159',
                 eval_launches['conv3x3_jvp'],
                 dict(jvp_conv_total, **jvp_conv_more)),
           bpd_eval_launches=(per_eval_bpd or {}).get('conv3x3_jvp')),
      dict(entry('groupnorm_act_jvp', 'groupnorm_jvp.cu',
                 'groupnorm_pallas.py:118',
                 eval_launches['groupnorm_act_jvp'],
                 dict(jvp_norm_total, **jvp_norm_more)),
           bpd_eval_launches=(per_eval_bpd or {}).get('groupnorm_act_jvp'),
           **{f'b{EVAL_BATCH}_{k}': v for k, v in dict(
               jvp_b256_total, prev_ms=jvp_b256_more['prev_ms']).items()}),
      dict(entry('groupnorm_act_jvp_cluster', 'groupnorm_jvp_cluster.cu',
                 'groupnorm_pallas.py:118', 0,
                 dict(jvp_norm_total, **jvp_norm_more), yardstick=True),
           **{f'b{EVAL_BATCH}_ms': jvp_b256_more['prev_ms']}),
      entry('groupnorm_act_pergroup', 'groupnorm_pergroup.cu',
            'groupnorm_pallas.py:118', 0, norm_all, yardstick=True),
      dict(entry('correlation', 'correlation.cu', 'correlation_pallas.py:42',
                 ukf_launches['correlation'], corr),
           phase2_launches=pinn_launches['correlation'],
           phase2_step_launches=step_launches['correlation'],
           phase2_step_device_ms=report['pinn']['k3_device_ms'],
           phase2_step_bound_ms=per_level * k3_step_bound,
           bpinn_launches=bpinn_train['launches']['correlation'],
           bpinn_step_launches=bpinn_step['correlation'],
           bpinn_step_device_ms=bpinn_train['k3_device_ms'],
           bpinn_step_bound_ms=k3_step_bound,
           **lfn_keys(('correlation',), 'k3')),
      dict(entry('correlation_bwd', 'correlation_bwd.cu',
                 'correlation_pallas.py:42',
                 prelim_launches['correlation_df1']
                 + prelim_launches['correlation_df2'], bwd_total),
           phase2_launches=pinn_launches['correlation_df1']
           + pinn_launches['correlation_df2'],
           phase2_step_launches=step_launches['correlation_df1']
           + step_launches['correlation_df2'],
           phase2_step_device_ms=report['pinn']['k3_bwd_device_ms'],
           phase2_step_ms_from_rows=per_level * bwd_total['ms'],
           phase2_step_bound_ms=per_level * bwd_step_bound,
           bpinn_launches=bpinn_train['launches']['correlation_df1']
           + bpinn_train['launches']['correlation_df2'],
           bpinn_step_launches=bpinn_step['correlation_df1']
           + bpinn_step['correlation_df2'],
           bpinn_step_device_ms=bpinn_train['k3_bwd_device_ms'],
           bpinn_step_bound_ms=bwd_step_bound,
           **lfn_keys(('correlation_df1', 'correlation_df2'), 'k3_bwd')),
      dict(entry('correlation_bwd_tile', 'correlation_bwd_tile.cu',
                 'correlation_pallas.py:42', 0, bwd_total, yardstick=True),
           phase2_step_ms_from_rows=per_level * bwd_total['prev_ms']),
      entry('correlation_tile', 'correlation_tile.cu',
            'correlation_pallas.py:42', 0, corr, yardstick=True),
      entry('ns_step_fused', 'ns_step.cu', 'ns_step_pallas.py:63',
            report['ukf']['ns_step_launches_by_kernel']['smem'], ns),
      entry('ns_step_staged', 'ns_step_staged.cu', 'ns_step_pallas.py:63',
            report['ukf']['ns_step_launches_by_kernel']['staged'], ns,
            yardstick=True),
  ]}
  report['table'] = table
  report['traces'] = dict(TRACES, leads_us=TRACE_LEADS)
  least = {}
  for t, lead in TRACE_LEADS:
    least[int(t // 100) * 100] = min(least.get(int(t // 100) * 100, lead),
                                     lead)
  log('least lead (us) of a device record over its launch call, by 100 s '
      'of the run: ' + ', '.join(f'{t} s: {v:.1f}'
                                 for t, v in sorted(least.items())))
  report['seconds'] = time.time() - t_start
  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'chip_smoke.json'), 'w') as f:
      json.dump(report, f, indent=1)
  log(f'total {report["seconds"]:.1f} s; {TRACES["taken"]} profiler traces, '
      f'{TRACES["incomplete"]} of them incomplete and taken again; '
      'kernel-table times (device ms): '
      'K1, K2 per U-Net forward (sum over the sites of one forward, bf16, '
      'batch 8), K1 as the data gradient per train step (bf16, batch '
      f'{train_batch}), K3, K4 per ukf cycle (f32), K3 backward (B1 + B2) '
      f'per prelim step (f32, batch {prelim_batch_size}), each yardstick '
      '(the first card design) at the same shapes; launches from the sampler '
      '(K1, K2), the train run (K1 data gradient), the ukf run (K3, K4) and '
      'the prelim run (K3 backward); phase2_* and bpinn_* keys: K3 and K3 '
      'backward launches over the phase-2 and B-PINN train runs and a step, '
      'their device ms in the profiled step and their bound a step (batch '
      f'{prelim_batch_size}); dps_* keys: K1, K1 data gradient, K2 '
      f'launches a DPS guided evaluation and over the dpm request, and one '
      f'evaluation\'s device ms, plain ms, library ms and bound (batch '
      f'{nc_batch}, bf16); conv3x3_jvp (K1 on the tangent) and '
      f'groupnorm_act_jvp: device ms per U-Net forward\'s sites (bf16, '
      f'batch 8), library ms torch.func.jvp of F.conv2d and of '
      f'F.group_norm + F.silu (primal and tangent), launches over the '
      f'evaluate run, bpd_eval_launches an evaluation; lfn_* keys: K3 and '
      f'K3 backward on the LiteFlowNet-PINN path (pinn/pinn_pde_lfn, batch '
      f'{prelim_batch_size}, f32), launches a forward, step and cycle and '
      f'over its runs, device ms at its stride-1 levels and in its '
      f'profiled steps, bounds; nc_train_* keys: K1, K1 data gradient and '
      f'K2 launches a vp/nc_ddpmpp DDPM train step and over its run; '
      f'ncsnpp_* and highres_* keys: K1, K1 data gradient and K2 on the '
      f'NCSN++ paths ({NCSNPP_CONFIG}, {HIGHRES_CONFIG}), launches a '
      f'forward, train step and PC evaluation and over their runs, device '
      f'ms of the site shapes the flagship rows do not time')
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
