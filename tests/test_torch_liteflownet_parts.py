"""The port's LiteFlowNet's pieces against flax (f32, CPU), at small
shapes: the grouped x2 deconvolution at 2 and 49 channels, the warp with
its channel bug, the neighbourhood unfold, the stride-2 cost volume (the
warp and the cost volume jitted, which op by op compile for seconds);
and ``get_flow_model``'s dispatch.  The whole cascade against JAX:
tests/test_torch_liteflownet.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.models import liteflownet as jax_lfn
from b_pinn_kalman_filter_tpu.ops.correlation_pallas import correlation_auto
from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.models import liteflownet
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3
from b_pinn_kalman_filter_tpu_torch.pinn import pinn as torch_pinn
from tests.port_parity import one_torch_thread  # noqa: F401


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want):
  want = np.asarray(want)
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  assert got.shape == want.shape, (got.shape, want.shape)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize('channels', [2, 49])
def test_grouped_deconv_matches_jax(channels):
  """The flow's (2) and the stride-2 cost volume's (49) x2 upsampling."""
  rng = np.random.default_rng(channels)
  x = rng.standard_normal((2, 5, 3, channels)).astype(np.float32)
  w = rng.standard_normal((4, 4, 1, channels)).astype(np.float32)
  want = jax_lfn.GroupedDeconv2x(channels).apply({'params': {'weight': w}},
                                                 x)
  port = liteflownet.GroupedDeconv2x(channels)
  params_from_jax({'weight': w}, port)
  with torch.no_grad():
    got = port(_t(x))
  assert got.shape == (2, 10, 6, channels)
  assert _rel(got, want) <= 1e-5


def test_backward_warp_matches_jax_with_its_channel_bug():
  """Flows of a few pixels, some out of the image: the port's warp equals
  the JAX one, and the flow's second channel changes nothing."""
  rng = np.random.default_rng(3)
  x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
  flow = (1.5 * rng.standard_normal((2, 6, 5, 2))).astype(np.float32)
  want = jax.jit(jax_lfn.backward_warp)(x, flow)
  got = liteflownet.backward_warp(_t(x), _t(flow))
  assert _rel(got, want) <= 1e-5
  other = flow.copy()
  other[..., 1] = rng.standard_normal((2, 6, 5))
  assert torch.equal(liteflownet.backward_warp(_t(x), _t(other)), got)


@pytest.mark.parametrize('k', [3, 5, 7])
def test_unfold_matches_jax(k):
  x = np.random.default_rng(k).standard_normal((2, 6, 5, 1)).astype(
      np.float32)
  want = jax_lfn._unfold(jnp.asarray(x), k)
  got = liteflownet._unfold(_t(x), k)
  assert got.shape == (2, 6, 5, k * k)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stride2_correlation_matches_jax():
  """Levels 3 and 2 take the stride-2 cost volume, the plain version in
  the port as in JAX's dispatch: no K3 launch is counted."""
  rng = np.random.default_rng(4)
  f1, f2 = rng.standard_normal((2, 2, 16, 16, 64)).astype(np.float32)
  want = jax.jit(lambda a, b: correlation_auto(a, b, stride=2))(f1, f2)
  launches = k3.correlation.launches
  got = k3.correlation(_t(f1), _t(f2), stride=2)
  assert got.shape == (2, 8, 8, 49)
  assert _rel(got, want) <= 1e-5
  assert k3.correlation.launches == launches


def test_get_flow_model_builds_liteflownet():
  """``model.arch='liteflownet'`` gives the LiteFlowNet (its cost volume
  the kernel or, with ``kernels=False``, the plain version) under the
  PINN's sub-network name ``flownet``, as in JAX."""
  config = configs.get_config('pinn/pinn_pde_lfn')
  net = torch_pinn.get_flow_model(config)
  assert isinstance(net, liteflownet.LiteFlowNet)
  assert net.Matching_0.correlation is k3.correlation
  plain = torch_pinn.get_flow_model(config, kernels=False)
  assert plain.Matching_0.correlation is k3.correlation_plain
  model = torch_pinn.PINN(config)
  assert isinstance(model.flownet, liteflownet.LiteFlowNet)
  assert {n.split('.', 1)[0] for n, _ in model.named_parameters()} == {
      'flownet', 'pressurenet'}
  with pytest.raises(ValueError, match='divisible by 32'):
    net(torch.zeros(1, 48, 48, 1), torch.zeros(1, 48, 48, 1))
