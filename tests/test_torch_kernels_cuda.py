"""The CUDA kernels (K1-K4) against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
Limits, relative to max |plain|: f32 1e-4, bf16 3e-2, as in chip_smoke.py.
"""

import pytest
import torch

from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from b_pinn_kalman_filter_tpu_torch.ops import ns_step as k4

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA card')
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.Generator(device='cuda').manual_seed(0)


def _rel(got, want):
  return float((got.float() - want.float()).abs().max()
               / want.float().abs().max())


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [
    (2, 16, 16, 256, 128),     # a main-path shape
    (3, 7, 9, 40, 72),         # odd H and W, ragged channel and pixel tiles
    (1, 1, 1, 32, 32),         # every tap but the centre falls in the halo
])
def test_conv3x3_matches_plain(card, shape, dtype):
  B, H, W, cin, cout = shape
  x = torch.randn((B, H, W, cin), generator=card, device='cuda').to(dtype)
  w = torch.randn((3, 3, cin, cout), generator=card, device='cuda') * 0.1
  b = torch.randn((cout,), generator=card, device='cuda')
  before = k1.conv3x3.launches
  with torch.inference_mode():
    got = k1.conv3x3(x, w, b)
    want = k1.conv3x3_plain(x, w, b)
  assert k1.conv3x3.launches == before + 1
  assert got.dtype == dtype and got.shape == want.shape
  assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('act', ['silu', 'elu', 'none'])
@pytest.mark.parametrize('shape,groups', [((2, 16, 16, 384), 32),
                                          ((3, 5, 7, 24), 8)])
def test_groupnorm_act_matches_plain(card, shape, groups, act, dtype):
  # An offset mean: the variance must not come from E[x^2] - E[x]^2.
  x = (torch.randn(shape, generator=card, device='cuda') * 2 + 3).to(dtype)
  scale = 1 + 0.1 * torch.randn((shape[-1],), generator=card, device='cuda')
  bias = 0.1 * torch.randn((shape[-1],), generator=card, device='cuda')
  before = k2.groupnorm_act.launches
  with torch.inference_mode():
    got = k2.groupnorm_act(x, scale, bias, groups, act)
    want = k2.groupnorm_act_plain(x, scale, bias, groups, act)
  assert k2.groupnorm_act.launches == before + 1
  assert got.dtype == dtype
  assert _rel(got, want) <= TOL[dtype]


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
  x16 = torch.zeros((1, 4, 4, 32), dtype=torch.float16, device='cuda')
  with pytest.raises(TypeError):
    k1.conv3x3(x16, torch.zeros((3, 3, 32, 32), device='cuda'))
  with pytest.raises(TypeError):
    k2.groupnorm_act(x16, torch.ones(32, device='cuda'),
                     torch.zeros(32, device='cuda'))
  x = torch.zeros((1, 4, 4, 30), device='cuda')
  with pytest.raises(ValueError, match='do not divide'):
    k2.groupnorm_act(x, torch.ones(30, device='cuda'),
                     torch.zeros(30, device='cuda'), num_groups=32)
  with pytest.raises(ValueError):
    k1.conv3x3(x, torch.zeros((3, 3, 32, 32), device='cuda'))
  w = torch.zeros((3, 3, 30, 8), device='cuda', requires_grad=True)
  with pytest.raises(RuntimeError, match='training slice'):
    k1.conv3x3(x, w)


def _rel_each(got, want):
  return max(_rel(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize('shape', [
    (1, 32, 32, 16), (1, 16, 16, 32), (1, 8, 8, 64), (1, 4, 4, 96),
    (1, 2, 2, 128),            # the five FlowNet levels at 64x64
    (8, 32, 32, 16),           # the draws folded into the batch
    (3, 13, 7, 3),             # odd H and W, ragged tiles and channels
    (2, 11, 19, 40),           # a ragged second channel chunk
    (2, 5, 9, 1),              # C = 1
])
def test_correlation_matches_plain(card, shape):
  f1 = torch.randn(shape, generator=card, device='cuda')
  f2 = torch.randn(shape, generator=card, device='cuda')
  before = k3.correlation.launches
  with torch.inference_mode():
    got = k3.correlation(f1, f2)
    want = k3.correlation_plain(f1, f2)
  assert k3.correlation.launches == before + 1
  assert got.shape == want.shape == shape[:3] + (49,)
  assert _rel(got, want) <= TOL[torch.float32]


def test_correlation_stride_2_stays_plain(card):
  f1 = torch.randn((1, 9, 9, 8), generator=card, device='cuda')
  before = k3.correlation.launches
  with torch.inference_mode():
    got = k3.correlation(f1, f1, stride=2)
  assert k3.correlation.launches == before
  assert torch.equal(got, k3.correlation_plain(f1, f1, stride=2))


@pytest.mark.parametrize('shape', [(129, 64, 64), (1, 64, 64), (3, 13, 7),
                                   (2, 2, 2)])
def test_ns_step_matches_plain(card, shape):
  d = torch.rand(shape, generator=card, device='cuda')
  u = 0.2 * torch.randn(shape, generator=card, device='cuda')
  v = 0.2 * torch.randn(shape, generator=card, device='cuda')
  p = 0.05 * torch.randn(shape, generator=card, device='cuda')
  # A region at rest: u = v = 0 takes the upwind side of sign(0) = +1.
  u[:, : shape[1] // 2, : shape[2] // 2] = 0
  v[:, : shape[1] // 2, : shape[2] // 2] = 0
  before = k4.ns_step_fused.launches
  with torch.inference_mode():
    got = k4.ns_step_fused(d, u, v, p, 0.0025, 1 / 200)
    want = k4.ns_step(d, u, v, p, 0.0025, 1 / 200)
  assert k4.ns_step_fused.launches == before + 1
  assert all(g.shape == w.shape for g, w in zip(got, want))
  assert _rel_each(got, want) <= TOL[torch.float32]


def test_flow_kernels_refuse_what_they_do_not_take(card):
  f64 = torch.zeros((1, 4, 4, 8), dtype=torch.float64, device='cuda')
  with pytest.raises(TypeError):
    k3.correlation(f64, f64)
  f = torch.zeros((1, 4, 4, 8), device='cuda')
  with pytest.raises(ValueError):
    k3.correlation(f, torch.zeros((1, 4, 4, 9), device='cuda'))
  with pytest.raises(RuntimeError, match='training slice'):
    k3.correlation(f.clone().requires_grad_(), f)
  line = torch.zeros((1, 1, 8), device='cuda')
  with pytest.raises(ValueError, match='>= 2'):
    k4.ns_step_fused(line, line, line, line, 0.0025, 1 / 200)
  g64 = torch.zeros((1, 4, 4), dtype=torch.float64, device='cuda')
  with pytest.raises(TypeError):
    k4.ns_step_fused(g64, g64, g64, g64, 0.0025, 1 / 200)
