#!/usr/bin/env python3
"""The K2 JVP kernel's and B1/B2's plans against their alternatives, on one
NVIDIA card.

    python3 scripts/kernel_plans_chip.py

Run from the root of a checkout on the card.  Device ms a call, as
``chip_smoke.py`` takes them (``device_ms``: complete ``torch.profiler``
traces of 20 calls):

- the K2 JVP kernel (``ops/groupnorm.py`` ``groupnorm_act_jvp``, bf16,
  SiLU, a tangent on x) at every flagship GroupNorm site, batches 8 and
  256, at the cluster ``jvp_plan`` gives and at 2 and 4 times it (up to
  8 blocks an image), beside the first design (on K2's cluster plan); per
  site and summed over a forward's 76 sites;
- B1 + B2 (``ops/correlation.py`` ``correlation_df1`` and
  ``correlation_df2``, f32) at the five FlowNet levels of
  ``pinn/pinn_pde``, batches 64 and 8, at every tiling and channel split
  the kernel takes (at most 256 threads, at least 16, within
  ``BWD_SMEM_BUDGET``), each checked against the plain version; the
  plan's tiling, the four fastest, and the first design (8x8 tiles).

Prints the card's name and power limit first.  Exits non-zero without a
CUDA card.
"""

import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as smoke  # noqa: E402
from b_pinn_kalman_filter_tpu_torch.ops import _build  # noqa: E402
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3  # noqa: E402
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2  # noqa: E402

# (H, C): GroupNorm sites a flagship forward (32 groups).
NORM_SITES = {(32, 128): 13, (32, 256): 4, (32, 384): 1, (16, 128): 1,
              (16, 256): 12, (16, 384): 1, (16, 512): 4, (8, 256): 13,
              (8, 512): 5, (4, 256): 17, (4, 512): 5}
LEVELS = [(32, 16), (16, 32), (8, 64), (4, 96), (2, 128)]


def jvp_plan_at(H, C, B, cluster, itemsize=2, G=32):
  """``jvp_plan``'s plan with its cluster replaced by ``cluster``."""
  plan = dict(k2.jvp_plan(H, H, C, G, itemsize, B))
  rows = math.ceil(H * H / cluster)
  chunk_rows = max(1, min(rows, k2.JVP_CHUNK_BYTES // (C * itemsize)))
  chunks = math.ceil(rows / chunk_rows)
  stage = -(-chunk_rows * C * itemsize // 128) * 128
  stages = max(1, min(chunks, k2.JVP_MAX_STAGES,
                      (k2.JVP_BLOCK_SMEM - plan['head_bytes']) // (2 * stage)))
  plan.update(cluster=cluster, rows=rows, chunk_rows=chunk_rows,
              chunks=chunks, stages=stages, on_chip=stages == chunks,
              smem_bytes=plan['head_bytes'] + 2 * stages * stage,
              blocks=cluster * B)
  return plan


def jvp_sweep(g):
  planned = k2.jvp_plan
  for B in (8, 256):
    total = {}
    for (H, C), n in NORM_SITES.items():
      x = (torch.randn((B, H, H, C), generator=g, device='cuda') * 2 + 0.5
           ).to(torch.bfloat16)
      dx = torch.randn((B, H, H, C), generator=g, device='cuda').to(
          torch.bfloat16)
      scale = torch.ones(C, device='cuda')
      bias = torch.zeros(C, device='cuda')
      want = k2.groupnorm_act_jvp_plain(x, dx, scale, bias, None, None, 32,
                                        'silu')
      base = planned(H, H, C, 32, 2, B)['cluster']
      row = {}
      for c in sorted({base, min(8, 2 * base), min(8, 4 * base)}):
        if c > 1 and 2 * c > H * H:
          continue
        plan = jvp_plan_at(H, C, B, c)
        k2.jvp_plan = lambda *a, plan=plan, **kw: plan
        try:
          got = k2.groupnorm_act_jvp(x, dx, scale, bias, None, None, 32,
                                     'silu')
          rel = smoke.rel_err(got, want)[1]
          ms = smoke.device_ms(lambda: k2.groupnorm_act_jvp(
              x, dx, scale, bias, None, None, 32, 'silu'))
        finally:
          k2.jvp_plan = planned
        assert rel <= smoke.TOL[torch.bfloat16], (H, C, c, rel)
        row[c] = ms
        key = 'plan' if c == base else f'x{c // base}'
        total[key] = total.get(key, 0.0) + ms * n
      first = smoke.device_ms(lambda: k2._groupnorm_act_jvp_cluster(
          x, dx, scale, bias, None, None, 32, 'silu'))
      bound = 3 * x.numel() * x.element_size() / smoke.HBM_BYTES_PER_S * 1e3
      for key, value in (('best', min(row.values())), ('first', first),
                         ('bound', bound)):
        total[key] = total.get(key, 0.0) + value * n
      print(f'jvp batch {B} {H}x{H}x{C} x{n}: by cluster '
            + ', '.join(f'{c}: {ms:.5f}' for c, ms in row.items())
            + f' (plan {base}); first design {first:.5f}; '
            f'bound {bound:.5f}',
            flush=True)
    print(f'jvp batch {B}, a forward\'s 76 sites: '
          + ', '.join(f'{k} {v:.4f}' for k, v in total.items()), flush=True)


def tilings(B, H, W, C):
  strip = 4 if W % 4 == 0 else 2 if W % 2 == 0 else 1
  splits = [1] + [s for s in (2, 4, 8, 16, 32)
                  if C % s == 0 and (C // s) % 4 == 0]
  for tw in range(strip, min(W, k3.MAX_TILE_W) + 1, strip):
    for th in range(1, H + 1):
      for split in splits:
        cs = C // split
        threads = th * (tw // strip) * -(-cs // 4)
        smem = k3._bwd_smem(th, tw, strip, cs)
        if (W % tw or H % th or not 16 <= threads <= k3.MAX_THREADS
            or smem > k3.BWD_SMEM_BUDGET):
          continue
        tiles = (H // th) * (W // tw)
        yield dict(strip=strip, tw=tw, th=th, split=split, cs=cs,
                   vec=int(C % 4 == 0), threads=threads, tiles=tiles,
                   blocks=B * tiles * split, smem_bytes=smem)


def bwd_sweep(g):
  planned = k3.correlation_bwd_plan
  short = ('th', 'tw', 'split', 'threads', 'blocks')
  for B in (64, 8):
    total = dict(plan=0.0, best=0.0, first=0.0, bound=0.0)
    for H, C in LEVELS:
      d = torch.randn((B, H, H, 49), generator=g, device='cuda')
      f = torch.randn((B, H, H, C), generator=g, device='cuda')
      want = {'df1': k3.correlation_df1_plain(d, f),
              'df2': k3.correlation_df2_plain(d, f)}
      chosen = planned(B, H, H, C)
      rows = []
      for plan in tilings(B, H, H, C):
        k3.correlation_bwd_plan = lambda *a, plan=plan: plan
        try:
          ms = 0.0
          for which in ('df1', 'df2'):
            rel = smoke.rel_err(k3._gradient(which, d, f), want[which])[1]
            assert rel <= smoke.TOL[torch.float32], (plan, which, rel)
            ms += smoke.device_ms(lambda: k3._gradient(which, d, f),
                                  iters=10)
        finally:
          k3.correlation_bwd_plan = planned
        rows.append((ms, plan))
      rows.sort(key=lambda r: r[0])
      mine = next(ms for ms, p in rows
                  if all(p[k] == chosen[k] for k in ('th', 'tw', 'split')))
      first = sum(smoke.device_ms(lambda: k3._gradient_tile(w, d, f))
                  for w in ('df1', 'df2'))
      bound = 2 * (49 + 2 * C) * B * H * H * 4 / smoke.HBM_BYTES_PER_S * 1e3
      for key, value in (('plan', mine), ('best', rows[0][0]),
                         ('first', first), ('bound', bound)):
        total[key] += value
      print(f'B1+B2 batch {B} {H}x{H}x{C}: plan {mine:.5f} '
            f'{ {k: chosen[k] for k in short} }; fastest '
            + '; '.join(f'{ms:.5f} { {k: p[k] for k in short} }'
                        for ms, p in rows[:4])
            + f'; first design {first:.5f}; bound {bound:.6f}; '
            f'{len(rows)} tilings',
            flush=True)
    print(f'B1+B2 batch {B}, the five levels: '
          + ', '.join(f'{k} {v:.4f}' for k, v in total.items()), flush=True)


def main():
  if not torch.cuda.is_available():
    print('needs an NVIDIA card', file=sys.stderr)
    return 2
  print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True).stdout.strip(), flush=True)
  _build.build_all(['groupnorm_jvp', 'groupnorm_jvp_cluster',
                    'correlation_bwd', 'correlation_bwd_tile'])
  g = torch.Generator(device='cuda').manual_seed(0)
  jvp_sweep(g)
  bwd_sweep(g)
  return 0


if __name__ == '__main__':
  sys.exit(main())
