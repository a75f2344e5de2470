#!/usr/bin/env python3
"""How often ``torch.profiler`` drops device records, on one NVIDIA card.

    python3 scripts/profiler_drops_chip.py [TRACES]   (default 200)

Run from the root of a checkout on the card.  For three functions, K1
(``conv3x3``, bf16, batch 8, 32x32x128 -> 128: the wgmma kernel), K2
(``groupnorm_act``, bf16, batch 16, 8x8x256, 32 groups) and K4's staged
kernel on one 64x64 frame (three short launches a call), takes TRACES
traces of 20 calls each way, in turns: bare; with ``chip_smoke.py``'s
idle margins (``TRACE_MARGIN_S``) at both ends; and as ``chip_smoke.py``
traces (a first call in the profiler's warm-up step, then the margins
around the measured call).  Each trace is checked as ``chip_smoke.py``
checks it (every kernel launch of the host has its device record).
Prints, for each function and way, the incomplete traces (index,
launches, device records) and the device ms a call of the complete
ones.  Exits non-zero without a CUDA card.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as smoke  # noqa: E402
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1  # noqa: E402
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2  # noqa: E402
from b_pinn_kalman_filter_tpu_torch.ops import ns_step as k4  # noqa: E402

CALLS = 20


def trace(fn, margin_s, warm):
  """One trace of CALLS calls: (complete, launches, device records, device
  ms a call)."""
  def calls():
    for _ in range(CALLS):
      fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
               schedule=schedule(wait=0, warmup=int(warm), active=1,
                                 repeat=1)) as prof:
    if warm:
      calls()
      torch.cuda.synchronize()
      prof.step()
    time.sleep(margin_s)
    calls()
    torch.cuda.synchronize()
    time.sleep(margin_s)
    prof.step()
  complete, launches, records, _ = smoke.trace_complete(prof)
  ms = sum(e.self_device_time_total
           for e in smoke.device_ops(prof)) * 1e-3 / CALLS
  return complete, launches, records, ms


def main():
  traces = int(sys.argv[1]) if len(sys.argv) > 1 else 200
  if not torch.cuda.is_available():
    print('profiler_drops_chip: no CUDA device', file=sys.stderr)
    return 2
  smoke.log(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  smoke._build.build_all()
  g = torch.Generator(device='cuda').manual_seed(0)
  xc = torch.randn((8, 32, 32, 128), generator=g, device='cuda').to(
      torch.bfloat16)
  w = (torch.randn((3, 3, 128, 128), generator=g, device='cuda') / 34
       ).to(torch.bfloat16)
  b = torch.zeros(128, device='cuda')
  x = torch.randn((16, 8, 8, 256), generator=g, device='cuda').to(
      torch.bfloat16)
  scale = torch.ones(256, device='cuda')
  bias = torch.zeros(256, device='cuda')
  fields = smoke.ns_fields((1, 64, 64), 0) + (smoke.NS_DT, smoke.NS_DX)
  fns = {'K1 (8, 32, 32, 128, 128) bf16': lambda: k1.conv3x3(xc, w, b),
         'K2 (16, 8, 8, 256) bf16':
         lambda: k2.groupnorm_act(x, scale, bias, 32, 'silu'),
         'K4 staged (1, 64, 64) f32':
         lambda: k4._ns_step_staged(*fields)}
  ways = {'bare': (0.0, False), 'margins': (smoke.TRACE_MARGIN_S, False),
          'warm-up step and margins': (smoke.TRACE_MARGIN_S, True)}
  with torch.inference_mode():
    for name, fn in fns.items():
      for _ in range(3):
        fn()
      seen = {way: ([], []) for way in ways}    # (complete ms, incomplete)
      start = time.time()
      for i in range(traces):
        for way, (margin, warm) in ways.items():
          complete, launches, records, ms = trace(fn, margin, warm)
          if complete:
            seen[way][0].append(ms)
          else:
            seen[way][1].append((i, launches, records))
      smoke.log(f'{name}: {traces} traces of {CALLS} calls each way in '
                f'{time.time() - start:.1f} s')
      for way, (ms, bad) in seen.items():
        smoke.log(f'  {way}: {len(bad)} incomplete (index, launches, '
                  f'device records): {bad[:12]}; complete: device ms a call '
                  + (f'median {np.median(ms):.5f}, min {min(ms):.5f}, max '
                     f'{max(ms):.5f}' if ms else 'none'))
  return 0


if __name__ == '__main__':
  sys.exit(main())
