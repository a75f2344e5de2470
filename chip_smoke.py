#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--steps N] [--requests R] [--cycles C] [--seed S]
                          [--out DIR]

Run from the root of a checkout; it needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and imports nothing of JAX or the JAX package.  Phases:

1. the card's name and power limit, as ``nvidia-smi`` gives them;
2. build the four CUDA kernels from ``b_pinn_kalman_filter_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build time;
3. find the K1/K2 sites' shapes from one full-width forward of the flagship
   U-Net (``vp/cifar10_ddpmpp_continuous``: nf 128, ch_mult (1,2,2,2), 4
   res blocks, 32x32, batch 8), then hold each kernel against its plain
   version on the card at every distinct shape, in f32 (TF32 off for convs
   and matmuls) and in bf16, and time kernel, plain version and the one
   PyTorch library call of the same function (cuDNN ``F.conv2d``;
   ``F.group_norm`` + ``F.silu``) with CUDA events;
4. hold K3 (cost volume) and K4 (NS step) against their plain versions in
   f32 at every shape the ``ukf`` path launches them with (the five FlowNet
   levels of ``pinn/pinn_pde`` at batch 1; the 129 sigma points and the
   rollout's one image at 64x64) and at an odd shape, and time both (no
   single PyTorch call computes either function);
5. a full-width flagship forward with every parameter randomised: the
   kernel path against the plain path, in f32 and bf16;
6. serve ``--requests`` sample requests through ``run_lib.sample`` (batch 8,
   N = ``--steps``, default the config's 1000, bf16) with the launch counts
   set to 0 before and read after; the counts must be the per-forward site
   counts times N times the requests, and the samples finite;
7. run the ``ukf`` entry point ``ukf_lib.run`` at the full width of
   ``pinn/pinn_pde`` (64x64, FlowNet levels 16..128, 8x8 patches: 256
   filters of dimension 64, 8 B-PINN draws a cycle) for ``--cycles``
   cycles (default 10) with seeded random B-PINN parameters, the launch
   counts set to 0 before and read after; the counts must be those of the
   design (K3: 5 levels x 8 draws a cycle; K4: one call a cycle with the
   129 sigma points, plus the 63 steps of the 64-frame rollout), the final
   belief finite with a nonnegative sqrt-covariance diagonal, and the
   filtered f-MSE below that of the noisy observation; then profile one
   steady cycle (``torch.profiler``): host and device-busy seconds of the
   measurement and of the filter, and their top device ops;
8. print the kernel table as one JSON line, then the ``{"ok": true, ...}``
   line.  With ``--out DIR`` the per-shape details go to
   ``DIR/chip_smoke.json``.

Error limits (relative to max |reference|), in phases 3 to 5: f32 1e-4;
bf16 3e-2, the bound tests/test_winograd.py holds bf16 Winograd to.

Any failed phase exits non-zero without the last line.  Without a CUDA card
it exits 2 and prints no result.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.data.ns_rollout import ns_rollout
from b_pinn_kalman_filter_tpu_torch.kalman import ukf_lib
from b_pinn_kalman_filter_tpu_torch.models import layers, registry
from b_pinn_kalman_filter_tpu_torch.ops import _build
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from b_pinn_kalman_filter_tpu_torch.ops import ns_step as k4
from b_pinn_kalman_filter_tpu_torch.pinn import bayes
from b_pinn_kalman_filter_tpu_torch.pinn.pinn_lib import init_pinn
from b_pinn_kalman_filter_tpu_torch.train import run_lib

CONFIG = 'vp/cifar10_ddpmpp_continuous'
BATCH = 8
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Published H100 SXM peaks (NVIDIA H100 datasheet): HBM 3.35 TB/s;
# bf16 tensor cores 989 TFLOP/s; f32 on the CUDA cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
UKF_CONFIG = 'pinn/pinn_pde'
NS_DT, NS_DX = 0.0025, 1 / 200
# f32 operations per pixel of one NS step, counted from csrc/ns_step.cu
# (stage 1: 10, stage 2: 2 x 96, stage 3: 19 + 96; a division as one).
NS_STEP_OPS = 317


def log(*args):
  print(*args, flush=True)


def time_ms(fn, iters=20, warmup=3):
  """Mean ms of ``fn()`` over ``iters`` back-to-back calls (CUDA events)."""
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


def bound(flops, nbytes, dtype):
  """Least time in ms and what sets it: bytes over the memory rate or
  operations over the peak rate of ``dtype``."""
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_FLOPS[dtype] * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


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
  w = torch.randn((3, 3, cin, cout), generator=g, device='cuda') / (
      9 * cin) ** 0.5
  b = 0.1 * torch.randn((cout,), generator=g, device='cuda')
  with torch.inference_mode():
    got = k1.conv3x3(x, w, b)
    want = k1.conv3x3_plain(x, w, b)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    # The library call on the same function: cuDNN on the NHWC data
    # (channels-last NCHW view) in the working dtype.
    x_lib = x.permute(0, 3, 1, 2)
    w_lib = w.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b_lib = b.to(dtype)
    row = dict(
        ms=time_ms(lambda: k1.conv3x3(x, w, b)),
        plain_ms=time_ms(lambda: k1.conv3x3_plain(x, w, b)),
        library_ms=time_ms(lambda: F.conv2d(x_lib, w_lib, b_lib, padding=1)))
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
    row = dict(
        ms=time_ms(lambda: k2.groupnorm_act(x, scale, bias, G, 'silu')),
        plain_ms=time_ms(
            lambda: k2.groupnorm_act_plain(x, scale, bias, G, 'silu')),
        library_ms=time_ms(lambda: F.silu(
            F.group_norm(x_lib, G, s_lib, b_lib, 1e-6))))
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
      log(f'  {name} {shape} {row["dtype"]:8s} x{count:<2d} '
          f'abs {row["max_abs_err"]:.3e} rel {row["rel_err"]:.3e} | '
          f'kernel {row["ms"]:.4f} ms plain {row["plain_ms"]:.4f} '
          f'library {row["library_ms"]:.4f} bound {row["bound_ms"]:.4f} '
          f'({row["bound_by"]})')
      if not row['rel_err'] <= TOL[dtype]:
        failures.append(f'{name} {shape} {row["dtype"]}: rel error '
                        f'{row["rel_err"]:.3e} > {TOL[dtype]}')
  bf16 = [r for r in rows if r['dtype'] == 'bfloat16']
  total = {k: sum(r[k] * r['per_forward'] for r in bf16)
           for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
  by = collections.Counter()
  for r in bf16:
    by[r['bound_by']] += r['bound_ms'] * r['per_forward']
  total['bound_by'] = by.most_common(1)[0][0]
  total['max_abs_err'] = max(r['max_abs_err'] for r in bf16)
  return rows, total, failures


def check_corr(shape, seed):
  """K3 against its plain version at (B, H, W, C), f32."""
  B, H, W, C = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  f1 = torch.randn(shape, generator=g, device='cuda')
  f2 = torch.randn(shape, generator=g, device='cuda')
  with torch.inference_mode():
    got = k3.correlation(f1, f2)
    want = k3.correlation_plain(f1, f2)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    row = dict(ms=time_ms(lambda: k3.correlation(f1, f2)),
               plain_ms=time_ms(lambda: k3.correlation_plain(f1, f2)),
               library_ms=None)
  pixels = B * H * W
  row['bound_ms'], row['bound_by'] = bound(
      2 * 49 * C * pixels, 2 * pixels * C * 4 + 49 * pixels * 4,
      torch.float32)
  row.update(max_abs_err=abs_err, rel_err=rel)
  return row


def check_ns(shape, seed):
  """K4 against its plain version at (B, H, W), f32; the error is the
  largest over the four fields."""
  B, H, W = shape
  g = torch.Generator(device='cuda').manual_seed(seed)
  d = torch.rand(shape, generator=g, device='cuda')
  u = 0.2 * torch.randn(shape, generator=g, device='cuda')
  v = 0.2 * torch.randn(shape, generator=g, device='cuda')
  p = 0.05 * torch.randn(shape, generator=g, device='cuda')
  u[:, :H // 2, :W // 2] = 0      # a region at rest: sign(0) = +1
  v[:, :H // 2, :W // 2] = 0
  args = (d, u, v, p, NS_DT, NS_DX)
  with torch.inference_mode():
    got = k4.ns_step_fused(*args)
    want = k4.ns_step(*args)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    row = dict(ms=time_ms(lambda: k4.ns_step_fused(*args)),
               plain_ms=time_ms(lambda: k4.ns_step(*args)),
               library_ms=None)
  pixels = B * H * W
  row['bound_ms'], row['bound_by'] = bound(NS_STEP_OPS * pixels,
                                           8 * pixels * 4, torch.float32)
  row.update(max_abs_err=max(e[0] for e in errs),
             rel_err=max(e[1] for e in errs))
  return row


def flow_kernel_phase(seed):
  """K3 and K4 at the ukf path's shapes and an odd one, f32.  Returns
  (rows, per-cycle totals, failures): a cycle runs K3 at each FlowNet
  level once per draw and K4 once on the 129 sigma points."""
  config = configs.get_config(UKF_CONFIG)
  size = config.data.image_size
  n = config.kf.patch_size ** 2
  levels = [(1, size >> (i + 1), size >> (i + 1), c)
            for i, c in enumerate(config.model.feature_nums)]
  corr_shapes = ([(s, ukf_lib.N_DRAWS) for s in levels]
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
      log(f'  {name} {shape} x{per_cycle:<2d} abs {row["max_abs_err"]:.3e} '
          f'rel {row["rel_err"]:.3e} | kernel {row["ms"]:.4f} ms plain '
          f'{row["plain_ms"]:.4f} bound {row["bound_ms"]:.6f} '
          f'({row["bound_by"]})')
      if not row['rel_err'] <= TOL[torch.float32]:
        failures.append(f'{name} {shape}: rel error {row["rel_err"]:.3e}')
    total = {k: sum(r[k] * r['per_cycle'] for r in mine)
             for k in ('ms', 'plain_ms', 'bound_ms')}
    by = collections.Counter()
    for r in mine:
      by[r['bound_by']] += r['bound_ms'] * r['per_cycle']
    total.update(bound_by=by.most_common(1)[0][0], library_ms=None,
                 max_abs_err=max(r['max_abs_err'] for r in mine))
    totals[name] = total
    rows += mine
  return rows, totals, failures


def ukf_phase(cycles, out_dir):
  """The ukf entry point at full pinn_pde width; returns (report,
  launches, expected launches, failures)."""
  config = configs.get_config(UKF_CONFIG)
  levels = len(config.model.feature_nums)
  frames = max(cycles + 2, 64)
  expected = {'correlation': levels * ukf_lib.N_DRAWS * cycles,
              'ns_step_fused': cycles + frames - 1}
  failures = []
  seconds = []
  with tempfile.TemporaryDirectory() as tmp:
    workdir = os.path.join(out_dir, 'ukf') if out_dir else tmp
    for kernel in (k1.conv3x3, k2.groupnorm_act, k3.correlation,
                   k4.ns_step_fused):
      kernel.launches = 0
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
      launches=launches, expected_launches=expected)
  log(f'  {cycles} cycles in {total_s:.2f} s (rollout, init and cycles); '
      f'steady cycle (cycles 2..{cycles}): measurement '
      f'{report["steady_measurement_s"]:.4f} s + filter '
      f'{report["steady_filter_s"]:.4f} s')
  log(f'  f-MSE filtered {mse:.4e} vs noisy observation {obs_mse:.4e}; '
      f'beliefs {tuple(mean.shape)}, min sqrt-cov diagonal '
      f'{report["min_sqrt_cov_diag"]:.3e}')
  log(f'  launches: {launches} (expected {expected})')
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
  return report, launches, failures


def ukf_profile_phase(seed):
  """One steady ukf cycle (after a warm one) under ``torch.profiler``, the
  measurement and the filter each in its own window: host seconds (the
  device synchronised at the end), device-busy seconds (the sum of the
  device ops' own times; one stream, so they do not overlap), kernel
  kernels and copies, and the top ones."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  config = configs.get_config(UKF_CONFIG)
  size = config.data.image_size
  data = ns_rollout(3, size, size, config.seed, device='cuda')
  model, params = init_pinn(config, seed=0, device='cuda')
  kf = ukf_lib.PINN_KF(config, model, bayes.make_bpinn_params(
      params, config, pretrained=False))
  generator = torch.Generator(device='cuda').manual_seed(seed)

  def prep(channel, idx):
    return data[idx, channel][None, :, :, None]

  kf.initialize(prep(2, 0), torch.cat([prep(3, 0), prep(4, 0)], dim=-1),
                prep(5, 0))
  t = torch.ones((1,), device='cuda')
  parts = {'measurement': lambda i: kf.measure(prep(0, i), prep(1, i), t,
                                               prep(2, i), generator),
           'filter': lambda i, m: kf.filter(prep(2, i), m)}
  parts['filter'](1, parts['measurement'](1))          # the warm cycle
  out, measurement = {}, None
  for name in ('measurement', 'filter'):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      start = time.perf_counter()
      if name == 'measurement':
        measurement = parts[name](2)
      else:
        parts[name](2, measurement)
      torch.cuda.synchronize()
      host_s = time.perf_counter() - start
    # The device's own events (kernels, copies), not the host ops that
    # launched them, whose device times would count each kernel twice.
    device_ops = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in device_ops) * 1e-6
    top = sorted(device_ops, key=lambda e: -e.self_device_time_total)[:6]
    # No device op in the trace means the profiler saw no device time,
    # not an idle device: the share is then not measured.
    out[name] = dict(
        host_s=host_s, device_busy_s=busy_s,
        idle_share=1 - busy_s / host_s if device_ops else None,
        device_ops=sum(e.count for e in device_ops),
        top=[(e.key, e.count, e.self_device_time_total * 1e-3) for e in top])
    share = out[name]['idle_share']
    log(f'  {name}: host {host_s:.4f} s, device busy {busy_s:.4f} s '
        f'(idle share {"not measured" if share is None else f"{share:.3f}"}'
        f'), {out[name]["device_ops"]} device kernels and copies')
    for key, count, ms in out[name]['top']:
      log(f'    {ms:9.3f} ms  x{count:<5d} {key[:90]}')
  return out


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
      t_kernel = time_ms(lambda: kernel_model(x, labels, train=False), 5, 1)
      t_plain = time_ms(lambda: plain_model(x, labels, train=False), 5, 1)
    name = str(dtype).split('.')[-1]
    out[name] = dict(max_abs_err=abs_err, rel_err=rel, tol=TOL[dtype],
                     max_abs_out=float(want.abs().max()),
                     kernel_forward_ms=t_kernel, plain_forward_ms=t_plain)
    log(f'  forward {name}: abs {abs_err:.3e} rel {rel:.3e} '
        f'(limit {TOL[dtype]}), max|y| {out[name]["max_abs_out"]:.3e}, '
        f'forward ms kernel path {t_kernel:.2f} plain path {t_plain:.2f}')
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
  for name, text in ptxas.items():
    for line in text.splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'  {name}: {line.strip()}')

  log('[kernels vs plain, main-path shapes]')
  _, model = flagship(torch.bfloat16, True, args.seed)
  config = model.config
  conv_sites, norm_sites = site_shapes(model, config, args.seed)
  per_forward = {'conv3x3': sum(conv_sites.values()),
                 'groupnorm_act': sum(norm_sites.values())}
  log(f'  sites per forward: {per_forward}')
  conv_rows, conv_total, f1 = kernel_phase('conv3x3', conv_sites, check_conv,
                                           args.seed)
  norm_rows, norm_total, f2 = kernel_phase('groupnorm_act', norm_sites,
                                           check_norm, args.seed)
  failures += f1 + f2
  report['kernels'] = {'conv3x3': conv_rows, 'groupnorm_act': norm_rows}

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
  for kernel in (k1.conv3x3, k2.groupnorm_act, k3.correlation,
                 k4.ns_step_fused):
    kernel.launches = 0
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
  log(f'  launches: {launches} (per forward {per_forward}, x {steps} steps '
      f'x {args.requests} requests)')
  for name, n in launches.items():
    if n == 0 or n != per_forward[name] * steps * args.requests:
      failures.append(f'{name}: {n} launches, expected '
                      f'{per_forward[name] * steps * args.requests}')
  report.update(requests=requests, launches=launches, steps=steps,
                per_forward=per_forward)

  config = configs.get_config(UKF_CONFIG)
  log(f'[ukf: {UKF_CONFIG}, {config.data.image_size}x'
      f'{config.data.image_size}, feature_nums {config.model.feature_nums}, '
      f'patch {config.kf.patch_size}, {args.cycles} cycles, '
      f'{ukf_lib.N_DRAWS} draws a cycle, f32]')
  report['ukf'], ukf_launches, f5 = ukf_phase(args.cycles, args.out)
  failures += f5
  log('[ukf: one steady cycle under torch.profiler]')
  report['ukf_profile'] = ukf_profile_phase(args.seed)

  table = {'kernels': [
      dict(name='conv3x3', route='cuda',
           source='b_pinn_kalman_filter_tpu_torch/csrc/conv3x3.cu',
           replaces='b_pinn_kalman_filter_tpu/ops/winograd_pallas.py:159',
           launches=launches['conv3x3'], **conv_total),
      dict(name='groupnorm_act', route='cuda',
           source='b_pinn_kalman_filter_tpu_torch/csrc/groupnorm.cu',
           replaces='b_pinn_kalman_filter_tpu/ops/groupnorm_pallas.py:118',
           launches=launches['groupnorm_act'], **norm_total),
      dict(name='correlation', route='cuda',
           source='b_pinn_kalman_filter_tpu_torch/csrc/correlation.cu',
           replaces='b_pinn_kalman_filter_tpu/ops/correlation_pallas.py:42',
           launches=ukf_launches['correlation'],
           **flow_totals['correlation']),
      dict(name='ns_step_fused', route='cuda',
           source='b_pinn_kalman_filter_tpu_torch/csrc/ns_step.cu',
           replaces='b_pinn_kalman_filter_tpu/ops/ns_step_pallas.py:63',
           launches=ukf_launches['ns_step_fused'],
           **flow_totals['ns_step_fused']),
  ]}
  report['table'] = table
  report['seconds'] = time.time() - t_start
  if args.out:
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, 'chip_smoke.json'), 'w') as f:
      json.dump(report, f, indent=1)
  log(f'total {report["seconds"]:.1f} s; kernel-table times: K1, K2 per '
      'U-Net forward (sum over the sites of one forward, bf16), K3, K4 per '
      'ukf cycle (f32); launches from the sampler (K1, K2) and the ukf run '
      '(K3, K4)')
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
