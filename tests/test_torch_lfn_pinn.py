"""The LiteFlowNet-PINN (``pinn/pinn_pde_lfn``) through the port's PINN
steps at 1x64x64 on the CPU, port only: one prelim step, one phase-2 step
and one B-PINN step, each finite and moving the state; and the phase-2
residual of the LiteFlowNet's outputs.  The LiteFlowNet reads no x, y or
t, so its flow's coordinate derivatives are zero and the residual is the
pressure's gradient alone, ``mean(p_x**2) + mean(p_y**2)``.  (The cascade
itself is held against JAX in tests/test_torch_liteflownet.py.)"""

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.models import layers
from b_pinn_kalman_filter_tpu_torch.pinn import bayes
from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
from b_pinn_kalman_filter_tpu_torch.pinn import pinn as torch_pinn
from b_pinn_kalman_filter_tpu_torch.train import state as state_lib
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

SIZE = 64


@pytest.fixture(scope='module')
def lfn():
  """(config (no warmup, so that a first step moves the parameters),
  PINN, its flat parameters, a batch and a mask)."""
  config = configs.get_config('pinn/pinn_pde_lfn')
  config.training.batch_size = 1
  config.optim.warmup = 0
  model = torch_pinn.PINN(config).eval()
  layers.init_params(model, torch.Generator().manual_seed(0))
  f1, f2, x, y, t = port_parity.pinn_inputs(batch=1, size=SIZE)
  rng = np.random.default_rng(1)
  target = (0.1 * rng.standard_normal((1, SIZE, SIZE, 3))).astype(np.float32)
  batch = tuple(torch.from_numpy(np.array(a)) for a in
                (f1, f2, x, y, t, target))
  mask = torch.from_numpy((rng.random((SIZE, SIZE, 1)) < 0.9).astype(
      np.float32))
  return config, model, dict(model.named_parameters()), batch, mask


def _step(step_fn, state, batch, mask):
  before = {k: v.detach().clone() for k, v in state.params.items()}
  state, out = step_fn(state, mask, batch, torch.Generator().manual_seed(2))
  assert all(np.isfinite(float(v)) for v in out)
  assert state.step == 1
  for key in ('flownet.', 'pressurenet.'):
    assert any(not torch.equal(before[k], v) for k, v in
               state.params.items() if k.startswith(key)), key
  return out


@pytest.mark.parametrize('phase', ['prelim', 'pinn', 'bpinn'])
def test_lfn_pinn_step_moves_the_state(lfn, phase):
  """One train step of the phase, from the PINN's seeded init (for the
  B-PINN, its MOPED posterior around it): finite losses, both
  sub-networks' parameters moved."""
  config, model, params, batch, mask = lfn
  if phase == 'bpinn':
    tx = pinn_losses.get_pinn_optimizer(config, 0.05, is_bpinn=True)
    start = bayes.flatten_posterior(bayes.make_bpinn_params(
        bayes.by_key(params), config, pretrained=True))
    get = bayes.get_bpinn_prelim_step_fn
  else:
    tx = pinn_losses.get_pinn_optimizer(config, 0.001)
    start = params
    get = {'prelim': pinn_losses.get_prelim_step_fn,
           'pinn': pinn_losses.get_pinn_step_fn}[phase]
  state = state_lib.create_train_state(start, tx, config.model.ema_rate)
  _step(get(config, model, tx, train=True), state, batch, mask)


def test_lfn_phase2_residual_is_the_pressure_gradient(lfn):
  """The phase-2 loss's residual term (``equation_mse`` on the PINN's
  outputs, times its weight) is ``mean(p_x**2) + mean(p_y**2)`` of the
  pressure on the predicted flow, times the weight: u and v do not depend
  on x, y or t."""
  config, model, params, batch, mask = lfn
  noise = tuple(torch.randn(batch[0].shape,
                            generator=torch.Generator().manual_seed(s))
                for s in (3, 4))
  _, pinn_loss, _ = pinn_losses.get_pinn_loss_fn(config, model)(
      params, mask, batch, noise=noise, create_graph=False)
  f1m, f2m = pinn_losses.masked_frames(config, batch, mask, None, noise)
  x, y, t = (c.detach().requires_grad_() for c in batch[2:5])
  flow, pres = model(f1m, f2m, x, y, t)
  u_grads = torch.autograd.grad(flow[-1].sum(), (x, y, t), allow_unused=True)
  assert all(g is None for g in u_grads)
  p_x, p_y = torch.autograd.grad(pres.sum(), (x, y))
  want = torch.mean(p_x ** 2) + torch.mean(p_y ** 2)
  weight = config.training.pinn_loss_weight
  assert float(pinn_loss) == pytest.approx(float(want) * weight, rel=1e-5)
  assert float(want) > 0
