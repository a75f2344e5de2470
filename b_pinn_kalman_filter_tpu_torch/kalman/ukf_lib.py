"""The patch-wise square-root UKF, the B-PINN measurement loop around it,
and the ``ukf`` entry point.

Counterpart of the JAX package's ``kalman/ukf_lib.py`` (``UKF``,
``PINN_KF``, ``run``).  Per filter cycle on the card: 8 posterior draws of
the PINN, one after another, each a FlowNet forward with one cost volume
(kernel K3) per pyramid level; then one predict whose NS dynamics step all
2n+1 sigma points in one call of kernel K4; then the update.  Not ported
yet: checkpoint restore, the PNG grid of ``run`` and the ``mesh=`` option.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from b_pinn_kalman_filter_tpu_torch.data.ns_rollout import ns_rollout
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.kalman import ukf as ukf_core
from b_pinn_kalman_filter_tpu_torch.kalman.dynamics import (IdentityKFMeasure,
                                                            NSDynamics)
from b_pinn_kalman_filter_tpu_torch.kalman.patching import patch, unpatch
from b_pinn_kalman_filter_tpu_torch.pinn import bayes
from b_pinn_kalman_filter_tpu_torch.pinn.pinn_lib import init_pinn

Tensor = torch.Tensor
N_DRAWS = 8   # B-PINN posterior draws per measurement


class UKF:
  """Patch-wise square-root UKF over (f, u, v, p) images."""

  def __init__(self, config):
    self.dim = config.kf.patch_size
    self.size = config.data.image_size
    self.dynamics = NSDynamics(config)
    self.measurement = IdentityKFMeasure(config)
    self.weights = ukf_core.merwe_weights(self.dim ** 2, alpha=1.0,
                                          beta=0.0, kappa=0.0)
    self.belief: Optional[ukf_core.UKFBelief] = None

  def initialize(self, x0: Tensor, var: float = 0.01):
    """Beliefs with mean ``x0`` (N, n) and covariance ``var`` I."""
    n = self.dim ** 2
    cov = torch.eye(n, dtype=x0.dtype, device=x0.device).expand(
        x0.shape[0], n, n) * var
    self.belief = ukf_core.initialize_beliefs(x0, cov)

  @torch.no_grad()
  def __call__(self, obsv: Tensor) -> Tensor:
    """One filter cycle on a (B, H, W, 4) observation image; returns the
    filtered (B, H, W, 4) mean."""
    self.belief = ukf_core.ukf_step(self.belief, patch(obsv, self.dim),
                                    self.weights, self.dynamics,
                                    self.measurement)
    return unpatch(self.belief.mean, self.dim, self.size, 4)


class PINN_KF:
  """B-PINN measurement + UKF fusion loop."""

  def __init__(self, config, model, bparams):
    self.config = config
    self.ukf = UKF(config)
    self.model = model
    self.bparams = bparams
    self.f_prev: Optional[Tensor] = None

  def initialize(self, f: Tensor, v: Tensor, p: Tensor, var: float = 1e-2):
    """State = patched [f, u, v, p] (``v`` holds both velocities)."""
    state = patch(torch.cat([f, v, p], dim=-1), self.config.kf.patch_size)
    self.ukf.initialize(state, var)
    self.f_prev = f

  @torch.no_grad()
  def measure(self, x, y, t, f,
              generator: Optional[torch.Generator] = None,
              draws: Optional[Sequence[bayes.Draw]] = None):
    """B-PINN MC measurement of the flow from the previous frame to ``f``:
    (flow mean, flow std, pressure mean, pressure std) over ``N_DRAWS``
    posterior draws (population std)."""
    if self.f_prev is None:
      self.f_prev = torch.full_like(f, 0.1)
    flows, press = bayes.sample_uvp(
        self.model, self.bparams, self.f_prev, f, x, y, t, n=N_DRAWS,
        size=(self.ukf.size, self.ukf.size), generator=generator,
        draws=draws)
    return (flows.mean(0), flows.std(0, correction=0), press.mean(0),
            press.std(0, correction=0))

  def filter(self, f: Tensor, measurement) -> Tensor:
    """Filter [f, flow, pressure] with the measured uncertainties; ``f``
    becomes the previous frame."""
    flow, flow_uncer, pres, pres_uncer = measurement
    self.f_prev = f
    self.ukf.measurement.update_uncertainty(flow_uncer, pres_uncer)
    return self.ukf(torch.cat([f, flow, pres], dim=-1))

  def __call__(self, x: Tensor, y: Tensor, t: Tensor, f: Tensor,
               generator: Optional[torch.Generator] = None,
               draws: Optional[Sequence[bayes.Draw]] = None) -> Tensor:
    """One cycle: measure, then filter.  Draws come from ``generator`` or
    are handed in."""
    return self.filter(f, self.measure(x, y, t, f, generator, draws))


def run(config, workdir: str, n_steps: int = 10, device=None,
        cycle_seconds: Optional[List[Tuple[float, float]]] = None) -> float:
  """The ``ukf`` entry point: B-PINN + UKF over a synthetic NS rollout.

  Seeded from ``config.seed`` (rollout, observation noise, draws); the
  PINN is initialised from seed 0 and its posterior built around it
  (``pretrained=False``): checkpoints are not ported yet.  Writes
  ``ukf_mse.txt`` (the f-MSE over all cycles), ``ukf_preds.npy``,
  ``ukf_gts.npy``, ``ukf_obsvs.npy`` ((n_steps, H, W) each) and the final
  belief ``ukf_belief.npz`` (``mean`` (N, n), ``sqrt_cov`` (N, n, n)) into
  ``workdir``; returns the f-MSE.  With ``cycle_seconds`` a list, each
  cycle appends its (measurement, filter) seconds on the host clock, the
  device synchronised around each part.
  """
  device = get_device(device)
  os.makedirs(workdir, exist_ok=True)
  size = config.data.image_size
  data = ns_rollout(max(n_steps + 2, 64), size, size, config.seed,
                    device=device)

  model, params = init_pinn(config, seed=0, device=device)
  pikal = PINN_KF(config, model,
                  bayes.make_bpinn_params(params, config, pretrained=False))
  generator = torch.Generator(device=device).manual_seed(config.seed)

  def prep(channel, idx):
    return data[idx, channel][None, :, :, None]

  def clock():
    if cycle_seconds is not None and device.type == 'cuda':
      torch.cuda.synchronize(device)
    return time.perf_counter()

  f0 = prep(2, 0)
  v0 = torch.cat([prep(3, 0), prep(4, 0)], dim=-1)
  pikal.initialize(f0, v0, prep(5, 0))

  preds, gts, obsvs = [], [], []
  t = torch.ones((1,), device=device)
  for i in range(1, n_steps + 1):
    f_gt = prep(2, i)
    f_obs = pikal.ukf.measurement.observe(generator, f_gt)
    start = clock()
    measurement = pikal.measure(prep(0, i), prep(1, i), t, f_obs,
                                generator=generator)
    measured = clock()
    pred = pikal.filter(f_obs, measurement)
    if cycle_seconds is not None:
      cycle_seconds.append((measured - start, clock() - measured))
    preds.append(pred[0, ..., 0])
    gts.append(f_gt[0, ..., 0])
    obsvs.append(f_obs[0, ..., 0])
    logging.info('ukf step %d: f MSE %.5e', i,
                 float(torch.mean((preds[-1] - gts[-1]) ** 2)))
    t = t + 1

  arrays = {name: torch.stack(v).cpu().numpy()
            for name, v in (('preds', preds), ('gts', gts),
                            ('obsvs', obsvs))}
  for name, array in arrays.items():
    np.save(os.path.join(workdir, f'ukf_{name}.npy'), array)
  belief = pikal.ukf.belief
  np.savez(os.path.join(workdir, 'ukf_belief.npz'),
           mean=belief.mean.cpu().numpy(),
           sqrt_cov=belief.sqrt_cov.cpu().numpy())
  final_mse = float(np.mean((arrays['preds'] - arrays['gts']) ** 2))
  with open(os.path.join(workdir, 'ukf_mse.txt'), 'w') as fh:
    fh.write(f'{final_mse}\n')
  return final_mse
