#!/usr/bin/env python3
"""DPS by Dormand–Prince (the config's ``RK45``) at the full width of
``inverse/nc_ddpmpp_inpaint_dps`` on one NVIDIA card: the NFE, the
solver's status, the steps and the seconds of one solve.

    python3 scripts/dps_rk45_chip.py

Run from the root of a checkout on the card.  The NC U-Net of
``chip_smoke.py`` (nf 128, batch 16, 64x64x1, bf16, every parameter
randomised, seed 0) with its random batch and mask; one solve too long
for ``chip_smoke.py``'s phase (thousands of guided evaluations, some 8
minutes on an H100).  Exits non-zero without a CUDA card or when the
sample is not finite.
"""

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as smoke  # noqa: E402
from b_pinn_kalman_filter_tpu_torch.inverse import (  # noqa: E402
    conditional_sampling as cs)


def main():
  if not torch.cuda.is_available():
    print('dps_rk45_chip: no CUDA device', file=sys.stderr)
    return 2
  smoke.log(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  smoke._build.build_all()
  config, model = smoke.nc_model(torch.bfloat16, True, 0)
  config.inverse.solver = 'RK45'
  _, op, y, shape = smoke.inverse_problem(config, 0)
  sde, eps = smoke.sde_lib.get_sde(config)
  obsv = smoke.obsv_sde.LOBSVSDE(sde, y, op)
  dps = cs.get_dps_sampler(config, obsv, shape, eps=eps, device='cuda')
  info = {}
  torch.cuda.synchronize()
  start = time.time()
  x = dps(model, generator=torch.Generator(device='cuda').manual_seed(0),
          info=info)
  torch.cuda.synchronize()
  seconds = time.time() - start
  finite = bool(torch.isfinite(x).all())
  smoke.log(f'done in {seconds:.1f} s: nfe {info["nfe"]}, status '
            f'{info["status"]}, {(info["nfe"] - 1) // 6} steps, finite '
            f'{finite}')
  return 0 if finite else 1


if __name__ == '__main__':
  sys.exit(main())
