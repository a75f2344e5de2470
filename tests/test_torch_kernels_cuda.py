"""The CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the other tests.)
Limits, relative to max |plain|: f32 1e-4, bf16 3e-2, as in chip_smoke.py.
"""

import pytest
import torch

from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2

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
