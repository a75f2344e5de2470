"""The CUDA kernels (K1-K4, K3's backward, and K1's and K2's forward-mode
rules with the K2 JVP kernel) and their first card designs (the
yardsticks) against their plain versions, on the card.

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


def _conv_inputs(card, shape, dtype):
  B, H, W, cin, cout = shape
  x = torch.randn((B, H, W, cin), generator=card, device='cuda').to(dtype)
  w = torch.randn((3, 3, cin, cout), generator=card, device='cuda') * 0.1
  b = torch.randn((cout,), generator=card, device='cuda')
  return x, w, b


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [
    (2, 16, 16, 256, 128),     # a main-path shape
    (8, 32, 32, 128, 128),     # one per level of the U-Net at batch 8:
    (8, 16, 16, 512, 256),     # 64 x 128 tiles at 32x32, 64 x 64 below,
    (8, 8, 8, 256, 256),       # split-K 4 at 8x8
    (8, 4, 4, 512, 256),       # and 8 at 4x4
    (3, 7, 9, 40, 72),         # odd H and W, ragged channel and pixel tiles
    (1, 1, 1, 32, 32),         # every tap but the centre falls in the halo
])
def test_conv3x3_matches_plain(card, shape, dtype):
  x, w, b = _conv_inputs(card, shape, dtype)
  which = k1.kernel_for(dtype, shape[3], shape[4])
  assert which == ('wgmma' if dtype == torch.bfloat16 else 'direct')
  before = k1.conv3x3.launches
  by_kernel = dict(k1.conv3x3.launches_by_kernel)
  with torch.inference_mode():
    got = k1.conv3x3(x, w, b)
    want = k1.conv3x3_plain(x, w, b)
  assert k1.conv3x3.launches == before + 1
  assert k1.conv3x3.launches_by_kernel == {
      k: n + (k == which) for k, n in by_kernel.items()}
  assert got.dtype == dtype and got.shape == want.shape
  assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize('shape', [(8, 4, 4, 512, 256), (8, 32, 32, 128, 128)])
def test_conv3x3_wgmma_is_deterministic_and_agrees_with_direct(card, shape):
  # Split-K sums its partials in a fixed order: two runs agree bit for bit.
  x, w, b = _conv_inputs(card, shape, torch.bfloat16)
  with torch.inference_mode():
    first = k1.conv3x3(x, w, b)
    again = k1.conv3x3(x, w, b)
    direct = k1._conv3x3_direct(x, w, b)
  assert torch.equal(first, again)
  assert _rel(first, direct) <= TOL[torch.bfloat16]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [
    (8, 32, 32, 128, 128),     # main-path sites at batch 8, one per level
    (8, 16, 16, 384, 256),
    (8, 8, 8, 256, 256),
    (8, 4, 4, 512, 256),
    (3, 7, 9, 40, 72),         # odd H and W, ragged tiles both ways
])
def test_conv3x3_backward_matches_plain(card, shape, dtype):
  """dx by a K1 launch on the flipped kernel (the kernel that
  ``kernel_for`` picks with Cin and Cout swapped), dW and db, against
  autograd through the plain version; the grads keep their dtypes."""
  x, w, b = _conv_inputs(card, shape, dtype)
  B, H, W, cin, cout = shape
  dy = torch.randn((B, H, W, cout), generator=card, device='cuda').to(dtype)
  which = k1.kernel_for(dtype, cout, cin)
  assert which == k1.kernel_for(dtype, cin, cout)
  by_use = dict(k1.conv3x3.launches_by_use)
  by_kernel = dict(k1.conv3x3.launches_by_kernel)
  args = [t.detach().requires_grad_() for t in (x, w, b)]
  got = torch.autograd.grad(k1.conv3x3(*args), args, dy)
  assert k1.conv3x3.launches_by_use == {
      'forward': by_use['forward'] + 1, 'data_grad': by_use['data_grad'] + 1,
      'jvp': by_use['jvp']}
  assert k1.conv3x3.launches_by_kernel == {
      k: n + 2 * (k == which) for k, n in by_kernel.items()}
  plain = [t.detach().requires_grad_() for t in (x, w, b)]
  want = torch.autograd.grad(k1.conv3x3_plain(*plain), plain, dy)
  for g, w_, t in zip(got, want, (x, w, b)):
    assert g.dtype == t.dtype and g.shape == t.shape
    assert _rel(g, w_) <= TOL[dtype]


def test_conv3x3_wgmma_takes_an_unaligned_view(card):
  x, w, b = _conv_inputs(card, (1, 4, 4, 72, 64), torch.bfloat16)
  view = x[..., 8:]                          # starts 16 bytes in: aligned
  odd = x.flatten()[1:1 + 4 * 4 * 64].reshape(1, 4, 4, 64)   # 2 bytes in
  w = w[:, :, :64]
  with torch.inference_mode():
    for t in (view, odd):
      assert _rel(k1.conv3x3(t, w, b), k1.conv3x3_plain(t, w, b)) <= TOL[
          torch.bfloat16]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('act', ['silu', 'elu', 'none'])
@pytest.mark.parametrize('shape,groups', [
    ((2, 16, 16, 384), 32),
    ((3, 5, 7, 24), 8),        # cg = 3: a 16-byte load spans three groups
    ((2, 48, 48, 24), 8),      # the same over a cluster of 4
    ((2, 3, 5, 30), 6),        # 60-byte pixel rows: scalar loads
    ((1, 40, 40, 30), 6),      # the same over a cluster of 4
    ((8, 32, 32, 384), 32),    # the largest main-path site: 98 KB a block
    ((8, 4, 4, 512), 32),      # two pixels a block
    ((1, 64, 64, 512), 32),    # larger than a cluster holds: re-read
])
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


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(8, 32, 32, 128), (8, 16, 16, 384),
                                   (8, 8, 8, 256), (8, 4, 4, 512)])
def test_groupnorm_act_backward_matches_plain(card, shape, dtype):
  """The forward by a K2 launch, the backward by recomputing the plain
  version: the gradients equal autograd through the plain version."""
  x = (torch.randn(shape, generator=card, device='cuda') * 2 + 3).to(dtype)
  scale = 1 + 0.1 * torch.randn((shape[-1],), generator=card, device='cuda')
  bias = 0.1 * torch.randn((shape[-1],), generator=card, device='cuda')
  dy = torch.randn(shape, generator=card, device='cuda').to(dtype)
  before = k2.groupnorm_act.launches
  args = [t.detach().requires_grad_() for t in (x, scale, bias)]
  y = k2.groupnorm_act(*args)
  got = torch.autograd.grad(y, args, dy)
  assert k2.groupnorm_act.launches == before + 1
  plain = [t.detach().requires_grad_() for t in (x, scale, bias)]
  want_y = k2.groupnorm_act_plain(*plain)
  want = torch.autograd.grad(want_y, plain, dy)
  assert _rel(y, want_y) <= TOL[dtype]
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize('dtype', DTYPES)
def test_groupnorm_act_pergroup_yardstick_matches_plain(card, dtype):
  x = (torch.randn((2, 8, 8, 256), generator=card, device='cuda') * 2 + 3
       ).to(dtype)
  scale = 1 + 0.1 * torch.randn((256,), generator=card, device='cuda')
  bias = 0.1 * torch.randn((256,), generator=card, device='cuda')
  before = k2.groupnorm_act.launches
  with torch.inference_mode():
    got = k2._groupnorm_act_pergroup(x, scale, bias)
    want = k2.groupnorm_act_plain(x, scale, bias)
    first = k2.groupnorm_act(x, scale, bias)
    again = k2.groupnorm_act(x, scale, bias)
  assert k2.groupnorm_act.launches == before + 2
  assert _rel(got, want) <= TOL[dtype]
  assert torch.equal(first, again)     # the cluster sums in a fixed order


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
  # Under autograd too: the backward's wrapper checks as the forward's.
  w = torch.zeros((3, 3, 32, 32), device='cuda', requires_grad=True)
  with pytest.raises(TypeError):
    k1.conv3x3(x16, w)


def _rel_each(got, want):
  return max(_rel(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize('shape', [
    (1, 32, 32, 16), (1, 16, 16, 32), (1, 8, 8, 64), (1, 4, 4, 96),
    (1, 2, 2, 128),            # the five FlowNet levels at 64x64, one draw
    (8, 32, 32, 16), (8, 16, 16, 32), (8, 8, 8, 64), (8, 4, 4, 96),
    (8, 2, 2, 128),            # the same with the 8 draws folded in
    (3, 13, 7, 3),             # odd H and W, C = 3: 4-byte copies
    (2, 11, 19, 40),           # two channel chunks: double-buffered
    (2, 5, 9, 1),              # C = 1
])
def test_correlation_matches_plain(card, shape):
  f1 = torch.randn(shape, generator=card, device='cuda')
  f2 = torch.randn(shape, generator=card, device='cuda')
  before = k3.correlation.launches
  batches = k3.correlation.batches.copy()
  with torch.inference_mode():
    got = k3.correlation(f1, f2)
    want = k3.correlation_plain(f1, f2)
  assert k3.correlation.launches == before + 1
  assert k3.correlation.batches - batches == {shape[0]: 1}
  assert got.shape == want.shape == shape[:3] + (49,)
  assert _rel(got, want) <= TOL[torch.float32]


@pytest.mark.parametrize('shape', [(8, 32, 32, 16), (8, 8, 8, 64),
                                   (8, 4, 4, 96), (8, 2, 2, 128)])
def test_correlation_is_deterministic(card, shape):
  # The cluster split sums its partials in rank order: the same bits.
  f1 = torch.randn(shape, generator=card, device='cuda')
  f2 = torch.randn(shape, generator=card, device='cuda')
  with torch.inference_mode():
    first = k3.correlation(f1, f2)
    again = k3.correlation(f1, f2)
  assert torch.equal(first, again)


def test_correlation_vmap_is_one_launch(card):
  # Three stacked draws of a (2, 16, 16, 32) level: one launch at batch 6.
  f1 = torch.randn((3, 2, 16, 16, 32), generator=card, device='cuda')
  f2 = torch.randn((3, 2, 16, 16, 32), generator=card, device='cuda')
  before = k3.correlation.launches
  batches = k3.correlation.batches.copy()
  with torch.inference_mode():
    got = torch.func.vmap(k3.correlation)(f1, f2)
    assert k3.correlation.launches == before + 1
    assert k3.correlation.batches - batches == {6: 1}
    want = torch.stack([k3.correlation_plain(a, b) for a, b in zip(f1, f2)])
  assert got.shape == want.shape
  assert _rel(got, want) <= TOL[torch.float32]


@pytest.mark.parametrize('shape', [(1, 32, 32, 16), (8, 4, 4, 96),
                                   (3, 13, 7, 3)])
def test_correlation_tile_yardstick_matches_plain(card, shape):
  f1 = torch.randn(shape, generator=card, device='cuda')
  f2 = torch.randn(shape, generator=card, device='cuda')
  before = k3.correlation.launches
  with torch.inference_mode():
    got = k3._correlation_tile(f1, f2)
    want = k3.correlation_plain(f1, f2)
  assert k3.correlation.launches == before
  assert _rel(got, want) <= TOL[torch.float32]


def test_correlation_stride_2_stays_plain(card):
  f1 = torch.randn((1, 9, 9, 8), generator=card, device='cuda')
  before = k3.correlation.launches
  with torch.inference_mode():
    got = k3.correlation(f1, f1, stride=2)
  assert k3.correlation.launches == before
  assert torch.equal(got, k3.correlation_plain(f1, f1, stride=2))


@pytest.mark.parametrize('shape', [
    (64, 32, 32, 16), (64, 16, 16, 32), (64, 8, 8, 64), (64, 4, 4, 96),
    (64, 2, 2, 128),           # the five FlowNet levels at batch 64
    (8, 32, 32, 16), (8, 16, 16, 32), (8, 8, 8, 64), (8, 4, 4, 96),
    (8, 2, 2, 128),            # and at batch 8
    (3, 13, 11, 24),           # odd H and W: one-pixel strips
    (2, 11, 19, 40),           # a channel split of 20
    (2, 5, 9, 1),              # C = 1
    (2, 5, 7, 3),              # C = 3, 5x7
])
def test_correlation_backward_matches_plain(card, shape):
  """B1 and B2 (csrc/correlation_bwd.cu, ``correlation_bwd_plan``) against
  their plain versions, each twice for its bits, and one launch each; the
  first card design (csrc/correlation_bwd_tile.cu, the yardstick) too."""
  d = torch.randn(shape[:3] + (49,), generator=card, device='cuda')
  g = torch.randn(shape, generator=card, device='cuda')
  for fn, plain in ((k3.correlation_df1, k3.correlation_df1_plain),
                    (k3.correlation_df2, k3.correlation_df2_plain)):
    before = fn.launches
    with torch.inference_mode():
      got = fn(d, g)
      again = fn(d, g)
      want = plain(d, g)
    assert fn.launches == before + 2
    assert got.shape == want.shape == shape
    assert _rel(got, want) <= TOL[torch.float32]
    assert torch.equal(got, again)       # a gather: no atomics
    which = 'df1' if fn is k3.correlation_df1 else 'df2'
    assert _rel(k3._gradient_tile(which, d, g), want) <= TOL[torch.float32]


@pytest.mark.parametrize('shape', [(8, 16, 16, 32), (3, 13, 11, 24)])
def test_correlation_second_order_matches_plain(card, shape):
  """The gradient of ``(df1 * r).sum() + (df2 * r).sum()`` in f1, f2 and
  dout, through the kernels' Functions, against autograd of the plain
  cost volume."""
  f1, f2, r = (torch.randn(shape, generator=card, device='cuda')
               for _ in range(3))
  dout = torch.randn(shape[:3] + (49,), generator=card, device='cuda')
  results = []
  for fn in (k3.correlation, k3.correlation_plain):
    leaves = [t.clone().requires_grad_() for t in (f1, f2, dout)]
    d1, d2 = torch.autograd.grad(fn(leaves[0], leaves[1]), leaves[:2],
                                 leaves[2], create_graph=True)
    results.append(torch.autograd.grad(((d1 + d2) * r).sum(), leaves))
  for got, want in zip(*results):
    assert _rel(got, want) <= TOL[torch.float32]


def _third_order(fn, f1, f2, dout, r, q):
  """The gradient in (f1, f2, dout) of a seeded linear functional (``q``)
  of the second-order product of ``fn`` (as in the test above)."""
  leaves = [t.clone().requires_grad_() for t in (f1, f2, dout)]
  d1, d2 = torch.autograd.grad(fn(leaves[0], leaves[1]), leaves[:2],
                               leaves[2], create_graph=True)
  second = torch.autograd.grad(((d1 + d2) * r).sum(), leaves,
                               create_graph=True)
  return torch.autograd.grad(sum((a * b).sum() for a, b in zip(second, q)),
                             leaves)


@pytest.mark.parametrize('shape', [(8, 16, 16, 32), (3, 13, 11, 24)])
def test_correlation_third_order_matches_plain(card, shape):
  """A third-order product through K3, B1 and B2 (the PINN residual's
  parameter gradient needs it) against autograd of the plain cost volume,
  within 1e-5 of max |plain|."""
  f1, f2, r, q1, q2 = (torch.randn(shape, generator=card, device='cuda')
                       for _ in range(5))
  dout, q3 = (torch.randn(shape[:3] + (49,), generator=card, device='cuda')
              for _ in range(2))
  before = [k3.correlation.launches, k3.correlation_df1.launches,
            k3.correlation_df2.launches]
  got = _third_order(k3.correlation, f1, f2, dout, r, (q1, q2, q3))
  assert all(n > b for n, b in zip(
      [k3.correlation.launches, k3.correlation_df1.launches,
       k3.correlation_df2.launches], before))
  want = _third_order(k3.correlation_plain, f1, f2, dout, r, (q1, q2, q3))
  for g, w in zip(got, want):
    assert _rel(g, w) <= 1e-5


def test_correlation_vmap_of_grad_is_one_launch_each(card):
  f1 = torch.randn((3, 2, 16, 16, 32), generator=card, device='cuda')
  f2 = torch.randn((3, 2, 16, 16, 32), generator=card, device='cuda')
  grad = torch.func.grad(lambda a, b: (k3.correlation(a, b) ** 2).sum(),
                         argnums=(0, 1))
  counts = [k3.correlation.launches, k3.correlation_df1.launches,
            k3.correlation_df2.launches]
  got = torch.func.vmap(grad)(f1, f2)
  assert [k3.correlation.launches, k3.correlation_df1.launches,
          k3.correlation_df2.launches] == [n + 1 for n in counts]
  loop = [grad(a, b) for a, b in zip(f1, f2)]
  for i in range(2):
    assert _rel(got[i], torch.stack([g[i] for g in loop])) <= TOL[
        torch.float32]


def test_wrappers_refuse_forward_mode_tangents(card):
  """K3 and its backward (B1, B2) have no forward-mode rule (no path takes
  one): a tangent must not be dropped by a launch, so the wrappers raise.
  K1 and K2 carry tangents (the tests below)."""
  fwd = torch.autograd.forward_ad
  x = torch.randn((1, 4, 4, 32), generator=card, device='cuda')
  with fwd.dual_level():
    dual = fwd.make_dual(x, torch.ones_like(x))
    for call in (lambda: k3.correlation(dual, x),
                 lambda: k3.correlation_df1(
                     torch.zeros((1, 4, 4, 49), device='cuda'), dual),
                 lambda: k3.correlation_df2(
                     torch.zeros((1, 4, 4, 49), device='cuda'), dual)):
      with pytest.raises(NotImplementedError, match='forward-mode rule'):
        call()
  with pytest.raises(NotImplementedError, match='forward-mode rule'):
    torch.func.jvp(lambda a: k3.correlation(a, x), (x,), (x,))


# K1's and K2's sites in the flagship U-Net (batch 8, 32x32): K1 (H, W,
# Cin, Cout) and K2 (H, W, C), every K2 site; K2's JVP streams x and dx
# again for its output pass at 32x32x384 in f32 (they do not fit two
# blocks an SM) and at (1, 64, 64, 512).
JVP_CONV_SITES = [(8, 32, 32, 128, 128), (8, 32, 32, 384, 128),
                  (8, 16, 16, 256, 256), (8, 8, 8, 512, 256),
                  (8, 4, 4, 256, 256)]
JVP_NORM_SITES = [(8, h, h, c) for h, c in (
    (32, 128), (32, 256), (32, 384), (16, 128), (16, 256), (16, 384),
    (16, 512), (8, 256), (8, 512), (4, 256), (4, 512))] + [(1, 64, 64, 512)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', JVP_CONV_SITES)
def test_conv3x3_jvp_matches_plain(card, shape, dtype):
  """``torch.func.jvp`` through K1 with a tangent on x (the likelihood's
  case: one K1 launch on it, counted as 'jvp') and on all three inputs
  (three terms), against the plain version's forward-mode AD."""
  x, w, b = _conv_inputs(card, shape, dtype)
  w = w.to(dtype)
  dx = torch.randn(x.shape, generator=card, device='cuda').to(dtype)
  dw = 0.1 * torch.randn(w.shape, generator=card, device='cuda').to(dtype)
  db = torch.randn(b.shape, generator=card, device='cuda')
  with torch.no_grad():
    before = dict(k1.conv3x3.launches_by_use)
    y, t = torch.func.jvp(lambda a: k1.conv3x3(a, w, b), (x,), (dx,))
    assert k1.conv3x3.launches_by_use == dict(
        before, forward=before['forward'] + 1, jvp=before['jvp'] + 1)
    want_y, want_t = torch.func.jvp(lambda a: k1.conv3x3_plain(a, w, b),
                                    (x,), (dx,))
    assert t.dtype == dtype
    assert _rel(y, want_y) <= TOL[dtype] and _rel(t, want_t) <= TOL[dtype]
    _, t3 = torch.func.jvp(k1.conv3x3, (x, w, b), (dx, dw, db))
    _, want3 = torch.func.jvp(k1.conv3x3_plain, (x, w, b), (dx, dw, db))
    assert t3.dtype == dtype and _rel(t3, want3) <= TOL[dtype]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('act', ['silu', 'elu', 'none'])
@pytest.mark.parametrize('shape', JVP_NORM_SITES)
def test_groupnorm_act_jvp_matches_plain(card, shape, act, dtype):
  """The K2 JVP kernel (one launch, beside K2's) against
  ``groupnorm_act_jvp_plain`` and against the plain version's
  forward-mode AD, with a tangent on x and on all three inputs (dscale
  and dbias absent, then present); streamed twice where ``jvp_plan`` says
  so; the same bits twice; the first card design (the yardstick) too."""
  C = shape[-1]
  x = (torch.randn(shape, generator=card, device='cuda') * 2 + 3).to(dtype)
  dx = torch.randn(shape, generator=card, device='cuda').to(dtype)
  scale = 1 + 0.1 * torch.randn((C,), generator=card, device='cuda')
  bias = 0.1 * torch.randn((C,), generator=card, device='cuda')
  ds = torch.randn((C,), generator=card, device='cuda')
  db = torch.randn((C,), generator=card, device='cuda')
  plan = k2.jvp_plan(shape[1], shape[2], C, 32, x.element_size(), shape[0])
  if shape == (1, 64, 64, 512) or (shape[1] == 32 and C == 384
                                   and dtype == torch.float32):
    assert not plan['on_chip']
  with torch.no_grad():
    n, nj = k2.groupnorm_act.launches, k2.groupnorm_act_jvp.launches
    y, t = torch.func.jvp(lambda a: k2.groupnorm_act(a, scale, bias, 32, act),
                          (x,), (dx,))
    assert (k2.groupnorm_act.launches, k2.groupnorm_act_jvp.launches) == (
        n + 1, nj + 1)
    plain = k2.groupnorm_act_jvp_plain(x, dx, scale, bias, None, None, 32,
                                       act)
    _, want = torch.func.jvp(
        lambda a: k2.groupnorm_act_plain(a, scale, bias, 32, act), (x,),
        (dx,))
    assert t.dtype == dtype
    assert _rel(t, plain) <= TOL[dtype] and _rel(t, want) <= TOL[dtype]
    assert torch.equal(y, k2.groupnorm_act(x, scale, bias, 32, act))
    args = (x, scale, bias)
    _, t3 = torch.func.jvp(
        lambda *a: k2.groupnorm_act(*a, 32, act), args, (dx, ds, db))
    _, want3 = torch.func.jvp(
        lambda *a: k2.groupnorm_act_plain(*a, 32, act), args, (dx, ds, db))
    assert _rel(t3, want3) <= TOL[dtype]
    # The same bits every run (the cluster's sums in a fixed order).
    again = k2.groupnorm_act_jvp(x, dx, scale, bias, None, None, 32, act)
    assert torch.equal(again, t)
    t3_again = k2.groupnorm_act_jvp(x, dx, scale, bias, ds, db, 32, act)
    assert torch.equal(t3_again, k2.groupnorm_act_jvp(x, dx, scale, bias, ds,
                                                      db, 32, act))
    old = k2._groupnorm_act_jvp_cluster(x, dx, scale, bias, None, None, 32,
                                        act)
    assert _rel(old, plain) <= TOL[dtype]


def test_unet_drift_and_divergence_kernel_path_matches_plain_path(card):
  """One probability-flow drift and Hutchinson divergence (one
  forward-mode pass) of the flagship U-Net cut to one res block at
  batch 2, bf16, every parameter randomised: within bf16's limit of the
  plain path; launches one K1 forward and one K1 'jvp' a K1 site, one K2
  and one K2 JVP a K2 site."""
  from b_pinn_kalman_filter_tpu_torch import configs
  from b_pinn_kalman_filter_tpu_torch.core import likelihood
  from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
  from b_pinn_kalman_filter_tpu_torch.models import registry
  out = {}
  for kernels in (True, False):
    config = configs.get_config('vp/cifar10_ddpmpp_continuous')
    config.model.num_res_blocks = 1
    model = registry.create_model(config, device='cuda', kernels=kernels)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
      for p in model.parameters():
        p.copy_(torch.randn(p.shape, generator=g) / (
            p[..., 0].numel() ** 0.5 if p.ndim >= 2 else 10.0))
    sde, _ = sde_lib.get_sde(config)
    score_fn = registry.get_score_fn(sde, model, continuous=True, params={
        k: v.detach() for k, v in model.named_parameters()})
    rsde = sde.reverse(score_fn, probability_flow=True)
    x = torch.randn((2, 32, 32, 3), generator=g).cuda()
    eps = torch.randint(0, 2, x.shape, generator=g).cuda().float() * 2 - 1
    k1.conv3x3.launches_by_use.update(forward=0, data_grad=0, jvp=0)
    k2.groupnorm_act.launches = k2.groupnorm_act_jvp.launches = 0
    with torch.no_grad():
      out[kernels] = likelihood.get_drift_div_fn(
          lambda a, t: rsde.sde(a, t)[0])(
              x, torch.full((2,), 0.5, device='cuda'), eps)
    uses = dict(k1.conv3x3.launches_by_use)
    counts = (uses, k2.groupnorm_act.launches, k2.groupnorm_act_jvp.launches)
    if kernels:
      assert uses['forward'] == uses['jvp'] > 0 and uses['data_grad'] == 0
      assert counts[1] == counts[2] > 0
    else:
      assert counts == ({'forward': 0, 'data_grad': 0, 'jvp': 0}, 0, 0)
  for got, want in zip(out[True], out[False]):
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL[torch.bfloat16]


def _prelim_setup(kernels, name='pinn/pinn_pde'):
  from b_pinn_kalman_filter_tpu_torch import configs
  from b_pinn_kalman_filter_tpu_torch.pinn.pinn import PINN
  config = configs.get_config(name)
  model = PINN(config, kernels=kernels)
  with torch.no_grad():      # every leaf drawn: no zero-init head
    g = torch.Generator().manual_seed(1)
    for p in model.parameters():
      v = torch.randn(p.shape, generator=g)
      p.copy_(v / p[..., 0].numel() ** 0.5 if p.ndim >= 2 else 0.1 * v)
  return config, model.cuda()


# The stride-1 levels of the LiteFlowNet (pinn/pinn_pde_lfn, 64x64):
# levels 6, 5 and 4 (levels 3 and 2 take the stride-2 plain cost volume).
LFN_LEVELS = [(2, 2, 192), (4, 4, 128), (8, 8, 96)]


@pytest.mark.parametrize('batch', [64, 8])
@pytest.mark.parametrize('level', LFN_LEVELS)
def test_correlation_and_backward_at_lfn_levels(card, level, batch):
  """K3, B1 and B2 at a LiteFlowNet level, at the train batch (64) and
  the ukf's 8 draws folded into the batch: one launch each against the
  plain versions."""
  shape = (batch,) + level
  f1, f2 = (torch.randn(shape, generator=card, device='cuda')
            for _ in range(2))
  d = torch.randn(shape[:3] + (49,), generator=card, device='cuda')
  cases = ((k3.correlation, k3.correlation_plain, (f1, f2)),
           (k3.correlation_df1, k3.correlation_df1_plain, (d, f2)),
           (k3.correlation_df2, k3.correlation_df2_plain, (d, f1)))
  for fn, plain, args in cases:
    before = fn.launches
    with torch.inference_mode():
      got = fn(*args)
      want = plain(*args)
    assert fn.launches == before + 1
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL[torch.float32], fn.__name__


def _lfn_inputs(card, B, S):
  """(f1, f2, x, y, t, target) of a PINN batch, uniform frames and
  coordinates, normal targets."""
  return (torch.rand((B, S, S, 1), generator=card, device='cuda'),
          torch.rand((B, S, S, 1), generator=card, device='cuda'),
          torch.rand((B, S, S, 1), generator=card, device='cuda'),
          torch.rand((B, S, S, 1), generator=card, device='cuda'),
          torch.arange(1, B + 1, device='cuda', dtype=torch.float32),
          torch.randn((B, S, S, 3), generator=card, device='cuda'))


def test_liteflownet_forward_kernel_path_matches_plain_path(card):
  """The LiteFlowNet of pinn/pinn_pde_lfn at batch 8, 64x64: every flow
  of the cascade on the kernels against the plain cost volumes, the same
  parameters; K3 launches once at each of levels 6, 5 and 4."""
  config, kernel_model = _prelim_setup(True, 'pinn/pinn_pde_lfn')
  _, plain_model = _prelim_setup(False, 'pinn/pinn_pde_lfn')
  f1, f2, x, y, t, _ = _lfn_inputs(card, 8, config.data.image_size)
  before = k3.correlation.launches
  sizes = k3.correlation.sizes.copy()
  with torch.inference_mode():
    got = kernel_model.flownet(f1, f2, x, y, t)
    assert k3.correlation.launches == before + 3
    assert k3.correlation.sizes - sizes == {(2, 2): 1, (4, 4): 1, (8, 8): 1}
    want = plain_model.flownet(f1, f2, x, y, t)
  assert len(got) == len(want) == 6
  for g, w in zip(got, want):
    assert _rel(g, w) <= TOL[torch.float32]


def test_prelim_step_gradients_kernel_path_match_plain_path(card):
  """One prelim loss's gradients at pinn_pde's full width (batch 4):
  the cost volumes on the kernels against their plain versions, the same
  parameters, batch, mask and noise; every leaf within 1e-4 of the
  largest leaf's gradient.  Each of the FlowNet's five levels launches
  K3, B1 and B2 once."""
  _check_prelim_gradients(card, 'pinn/pinn_pde', 5)


def test_lfn_prelim_step_gradients_kernel_path_match_plain_path(card):
  """The same at pinn/pinn_pde_lfn: the LiteFlowNet's three stride-1
  levels each launch K3, B1 and B2 once."""
  _check_prelim_gradients(card, 'pinn/pinn_pde_lfn', len(LFN_LEVELS))


def _check_prelim_gradients(card, name, levels):
  from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
  config, kernel_model = _prelim_setup(True, name)
  _, plain_model = _prelim_setup(False, name)
  B, S = 4, config.data.image_size
  batch = _lfn_inputs(card, B, S)
  mask = (torch.rand((S, S, 1), generator=card, device='cuda') < 0.9).float()
  noise = tuple(torch.randn((B, S, S, 1), generator=card, device='cuda')
                for _ in range(2))
  before = [k3.correlation.launches, k3.correlation_df1.launches,
            k3.correlation_df2.launches]
  grads = []
  for model in (kernel_model, plain_model):
    params = dict(model.named_parameters())
    loss, _, _ = pinn_losses.get_prelim_loss_fn(config, model)(
        params, mask, batch, noise=noise)
    grads.append(dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))))
  assert [k3.correlation.launches, k3.correlation_df1.launches,
          k3.correlation_df2.launches] == [n + levels for n in before]
  top = max(float(v.abs().max()) for v in grads[1].values())
  for leaf, want in grads[1].items():
    assert float((grads[0][leaf] - want).abs().max()) <= (
        TOL[torch.float32] * top), leaf


def test_pinn_residual_gradient_kernel_path_matches_plain_path(card):
  """The phase-2 loss at pinn_pde's full width (batch 2): the gradient of
  the NS residual alone (at Re 1e7 and the loss weight 1e-5 it would
  vanish inside the total) and of the whole loss, cost volumes on the
  kernels against their plain versions; every leaf within 1e-4 of the
  largest leaf's gradient.  Per level, the residual's gradient launches
  K3, B1 and B2 29 times each: the forward 1 K3; u's and v's first
  derivatives 2 B1 and 2 B2; the four second derivatives 8 of each; the
  parameter gradient the rest."""
  from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
  from b_pinn_kalman_filter_tpu_torch.pinn import pinn
  config, kernel_model = _prelim_setup(True)
  _, plain_model = _prelim_setup(False)
  B, S = 2, config.data.image_size
  x, y = (torch.linspace(0, 1, S, device='cuda') + 0.01 * torch.rand(
      (B, S, S), generator=card, device='cuda') for _ in range(2))
  batch = (torch.rand((B, S, S, 1), generator=card, device='cuda'),
           torch.rand((B, S, S, 1), generator=card, device='cuda'),
           x[..., None], y.transpose(1, 2)[..., None],
           torch.arange(1, B + 1, device='cuda', dtype=torch.float32),
           torch.randn((B, S, S, 3), generator=card, device='cuda'))
  mask = (torch.rand((S, S, 1), generator=card, device='cuda') < 0.9).float()
  noise = tuple(torch.randn((B, S, S, 1), generator=card, device='cuda')
                for _ in range(2))
  kernels = (k3.correlation, k3.correlation_df1, k3.correlation_df2)
  results, stages = [], []

  def trace(stage):
    stages.append((stage, [k.launches for k in kernels]))

  for model in (kernel_model, plain_model):
    params = dict(model.named_parameters())
    for k in kernels:
      k.launches = 0
    f1, f2, x, y, t, _ = batch
    residual = pinn.equation_mse_from_outputs(
        model, params, f1, f2, x, y, t, pinn_losses.RE, trace=trace)
    g_res = torch.autograd.grad(residual, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    trace('parameter gradient')
    loss, _, _ = pinn_losses.get_pinn_loss_fn(config, model)(
        params, mask, batch, noise=noise)
    g_all = torch.autograd.grad(loss, list(params.values()))
    results.append([dict(zip(params, g)) for g in (g_res, g_all)])
  levels = len(config.model.feature_nums)
  assert stages[:4] == [
      (stage, [n * levels for n in counts]) for stage, counts in (
          ('forward', (1, 0, 0)), ('first', (1, 2, 2)),
          ('second', (9, 10, 10)), ('parameter gradient', (29, 29, 29)))]
  assert all(k.sizes[(S // 2, S // 2)] > 0 for k in kernels)
  for got, want in zip(*results):
    top = max(float(v.abs().max()) for v in want.values())
    for name, w in want.items():
      assert float((got[name] - w).abs().max()) <= (
          TOL[torch.float32] * top), name


def test_bpinn_step_launches_and_data_gradient_match_plain_path(card):
  """One B-PINN step at pinn_pde's full width (batch 2) on a MOPED
  posterior: a train step launches K3, B1 and B2 once a level, an eval
  step K3 once a level; the gradient in mu and rho of the data MSEs alone
  (the KL terms, far larger, would hide it), cost volumes on the kernels
  against their plain versions, every leaf within 1e-4 of the largest
  leaf's."""
  from b_pinn_kalman_filter_tpu_torch.pinn import bayes
  from b_pinn_kalman_filter_tpu_torch.pinn import losses as pinn_losses
  from b_pinn_kalman_filter_tpu_torch.train.state import create_train_state
  config, kernel_model = _prelim_setup(True)
  _, plain_model = _prelim_setup(False)
  config.training.batch_size = B = 2
  S = config.data.image_size
  batch = (torch.rand((B, S, S, 1), generator=card, device='cuda'),
           torch.rand((B, S, S, 1), generator=card, device='cuda'),
           torch.rand((B, S, S, 1), generator=card, device='cuda'),
           torch.rand((B, S, S, 1), generator=card, device='cuda'),
           torch.arange(1, B + 1, device='cuda', dtype=torch.float32),
           torch.randn((B, S, S, 3), generator=card, device='cuda'))
  mask = (torch.rand((S, S, 1), generator=card, device='cuda') < 0.9).float()
  noise = tuple(torch.randn((B, S, S, 1), generator=card, device='cuda')
                for _ in range(2))
  posterior = bayes.flatten_posterior(bayes.make_bpinn_params(
      {key: {n: p.detach() for n, p in getattr(kernel_model, key)
             .named_parameters()} for key in ('flownet', 'pressurenet')},
      config))
  eps = bayes.sample_eps(card, bayes.nest_posterior(posterior))
  kernels = (k3.correlation, k3.correlation_df1, k3.correlation_df2)
  levels = len(config.model.feature_nums)
  grads = []
  for model in (kernel_model, plain_model):
    params = {k: v.clone().requires_grad_() for k, v in posterior.items()}
    *_, terms = bayes.get_bpinn_loss_fn(config, model)(
        params, mask, batch, noise=noise, eps=eps)
    grads.append(dict(zip(params, torch.autograd.grad(
        terms['flow_mse'] + terms['pres_mse'], list(params.values()),
        allow_unused=True, materialize_grads=True))))
  top = max(float(v.abs().max()) for v in grads[1].values())
  for name, want in grads[1].items():
    assert float((grads[0][name] - want).abs().max()) <= (
        TOL[torch.float32] * top), name

  tx = pinn_losses.get_pinn_optimizer(config, lr_mul_pres=0.05,
                                      is_bpinn=True)
  state = create_train_state(
      {k: v.clone() for k, v in posterior.items()}, tx, config.model.ema_rate)
  for train, want in ((True, [levels] * 3), (False, [levels, 0, 0])):
    step = bayes.get_bpinn_prelim_step_fn(config, kernel_model, tx, train)
    for k in kernels:
      k.launches = 0
    step(state, mask, batch, card)
    assert [k.launches for k in kernels] == want, train
  assert state.step == 1


# The inverse suite's NC U-Net (inverse/nc_ddpmpp_inpaint_dps: 64x64x1,
# batch 16): K1 sites at every level, K1's TMA box (1, 1, 64) at 64x64,
# and K2's re-read branch (on_chip False) at 64x64 in f32 and bf16.
NC_CONV_SITES = [(16, 64, 64, 128, 128), (16, 64, 64, 384, 128),
                 (16, 64, 64, 256, 256), (16, 32, 32, 512, 256),
                 (16, 16, 16, 512, 256), (16, 8, 8, 256, 256)]
NC_NORM_SITES = [(16, 64, 64, 128), (16, 64, 64, 384), (16, 32, 32, 512),
                 (16, 8, 8, 512)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', NC_CONV_SITES)
def test_conv3x3_nc_sites_forward_and_data_gradient(card, shape, dtype):
  """K1 and its data gradient at the NC U-Net's sites against the plain
  version (at 64x64 the wgmma kernel's box is one 64-pixel row)."""
  x, w, b = _conv_inputs(card, shape, dtype)
  B, H, W, cin, cout = shape
  if dtype == torch.bfloat16 and W == 64:
    assert k1.wgmma_plan(B, H, W, cin, cout)['box'] == (1, 1, 64)
  dy = torch.randn((B, H, W, cout), generator=card, device='cuda').to(dtype)
  x = x.requires_grad_()
  y = k1.conv3x3(x, w, b)
  dx, = torch.autograd.grad(y, x, dy)
  plain_x = x.detach().requires_grad_()
  want_y = k1.conv3x3_plain(plain_x, w, b)
  want_dx, = torch.autograd.grad(want_y, plain_x, dy)
  assert _rel(y.detach(), want_y.detach()) <= TOL[dtype]
  assert _rel(dx, want_dx) <= TOL[dtype]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', NC_NORM_SITES)
def test_groupnorm_act_nc_sites(card, shape, dtype):
  """K2 at the NC sites, the re-read branch where the plan says so (64x64
  at 128 channels in f32 above all, 256 KiB a block of the cluster)."""
  H, W, C = shape[1:]
  plan = k2.groupnorm_plan(H, W, C, 32, torch.tensor([], dtype=dtype)
                           .element_size())
  if (H, C, dtype) == (64, 128, torch.float32):
    assert not plan['on_chip']
  x = (torch.randn(shape, generator=card, device='cuda') * 2 + 3).to(dtype)
  scale = 1 + 0.1 * torch.randn((C,), generator=card, device='cuda')
  bias = 0.1 * torch.randn((C,), generator=card, device='cuda')
  with torch.inference_mode():
    got = k2.groupnorm_act(x, scale, bias, 32, 'silu')
    want = k2.groupnorm_act_plain(x, scale, bias, 32, 'silu')
  assert _rel(got, want) <= TOL[dtype]


def test_dps_guided_evaluation_kernel_path_matches_plain_path(card):
  """One DPS guided evaluation through the NC U-Net cut to 2 res blocks
  at batch 2 (64x64, bf16, every parameter randomised): the score and
  score_cond within bf16's limit of the plain path, and the launches an
  evaluation one K1 forward and one K1 data gradient a K1 site, one K2 a
  K2 site."""
  from b_pinn_kalman_filter_tpu_torch import configs
  from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
  from b_pinn_kalman_filter_tpu_torch.inverse import conditional_sampling
  from b_pinn_kalman_filter_tpu_torch.inverse import operators
  from b_pinn_kalman_filter_tpu_torch.models import registry
  out = {}
  for kernels in (True, False):
    config = configs.get_config('inverse/nc_ddpmpp_inpaint_dps')
    config.model.num_res_blocks = 2
    model = registry.create_model(config, device='cuda', kernels=kernels)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
      for p in model.parameters():
        p.copy_(torch.randn(p.shape, generator=g) / (
            p[..., 0].numel() ** 0.5 if p.ndim >= 2 else 10.0))
    sde, _ = sde_lib.get_sde(config)
    op = operators.InpaintOperator(mask=(torch.rand(
        (64, 64, 1), generator=g) > 0.5).float(), device='cuda')
    x = torch.randn((2, 64, 64, 1), generator=g).cuda()
    y = op(torch.rand((2, 64, 64, 1), generator=g).cuda(), keep_shape=False)
    score_fn = registry.get_score_fn(sde, model, continuous=True, params={
        k: v.detach() for k, v in model.named_parameters()})
    guidance = conditional_sampling.dps_guidance(sde, score_fn, y, op, 0.1)
    k1.conv3x3.launches_by_use.update(forward=0, data_grad=0, jvp=0)
    k2.groupnorm_act.launches = 0
    out[kernels] = guidance(x, torch.full((2,), 0.5, device='cuda'))
    counts = (dict(k1.conv3x3.launches_by_use), k2.groupnorm_act.launches)
    if kernels:
      assert counts[0]['forward'] == counts[0]['data_grad'] > 0
      assert counts[1] > 0
    else:
      assert counts == ({'forward': 0, 'data_grad': 0, 'jvp': 0}, 0)
  for got, want in zip(out[True], out[False]):
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= TOL[torch.bfloat16]


def _ns_fields(card, shape):
  d = torch.rand(shape, generator=card, device='cuda')
  u = 0.2 * torch.randn(shape, generator=card, device='cuda')
  v = 0.2 * torch.randn(shape, generator=card, device='cuda')
  p = 0.05 * torch.randn(shape, generator=card, device='cuda')
  # A region at rest: u = v = 0 takes the upwind side of sign(0) = +1.
  u[:, : shape[1] // 2, : shape[2] // 2] = 0
  v[:, : shape[1] // 2, : shape[2] // 2] = 0
  return d, u, v, p


@pytest.mark.parametrize('shape', [
    (129, 64, 64),             # the UKF's sigma points: a block an image
    (1, 64, 64),               # the rollout: an image over a cluster of 8
    (33, 64, 64),              # clusters of 4
    (3, 13, 7), (2, 2, 2),     # odd sizes; a row a block
    (2, 128, 128),             # past shared memory: the staged kernel
])
def test_ns_step_matches_plain(card, shape):
  d, u, v, p = _ns_fields(card, shape)
  which = k4.ns_step_plan(*shape)['kernel']
  assert which == ('staged' if shape[1] == 128 else 'smem')
  before = k4.ns_step_fused.launches
  by_kernel = dict(k4.ns_step_fused.launches_by_kernel)
  with torch.inference_mode():
    got = k4.ns_step_fused(d, u, v, p, 0.0025, 1 / 200)
    want = k4.ns_step(d, u, v, p, 0.0025, 1 / 200)
  assert k4.ns_step_fused.launches == before + 1
  assert k4.ns_step_fused.launches_by_kernel == {
      k: n + (k == which) for k, n in by_kernel.items()}
  assert all(g.shape == w.shape for g, w in zip(got, want))
  assert _rel_each(got, want) <= TOL[torch.float32]


@pytest.mark.parametrize('shape', [(129, 64, 64), (1, 64, 64), (3, 13, 7)])
def test_ns_step_one_launch_agrees_with_staged(card, shape):
  d, u, v, p = _ns_fields(card, shape)
  before = k4.ns_step_fused.launches
  with torch.inference_mode():
    staged = k4._ns_step_staged(d, u, v, p, 0.0025, 1 / 200)
    assert k4.ns_step_fused.launches == before
    got = k4.ns_step_fused(d, u, v, p, 0.0025, 1 / 200)
    want = k4.ns_step(d, u, v, p, 0.0025, 1 / 200)
  assert _rel_each(staged, want) <= TOL[torch.float32]
  assert _rel_each(got, staged) <= TOL[torch.float32]


def test_flow_kernels_refuse_what_they_do_not_take(card):
  f64 = torch.zeros((1, 4, 4, 8), dtype=torch.float64, device='cuda')
  with pytest.raises(TypeError):
    k3.correlation(f64, f64)
  f = torch.zeros((1, 4, 4, 8), device='cuda')
  with pytest.raises(ValueError):
    k3.correlation(f, torch.zeros((1, 4, 4, 9), device='cuda'))
  with pytest.raises(ValueError):
    k3.correlation_df1(torch.zeros((1, 4, 4, 48), device='cuda'), f)
  line = torch.zeros((1, 1, 8), device='cuda')
  with pytest.raises(ValueError, match='>= 2'):
    k4.ns_step_fused(line, line, line, line, 0.0025, 1 / 200)
  g64 = torch.zeros((1, 4, 4), dtype=torch.float64, device='cuda')
  with pytest.raises(TypeError):
    k4.ns_step_fused(g64, g64, g64, g64, 0.0025, 1 / 200)


# NCSN++: K1's one new site shape at ve/cifar10_ncsnpp_continuous
# (16x16x128->128) and the sites of ve/church_ncsnpp_continuous's 32^2 to
# 256^2 levels, batch 8 (its batch 64 cut to 8); K2 at 256x256x128 takes
# the re-read plan (JAX's fits_fused_groupnorm refuses that shape on the
# TPU).
NCSNPP_CONV_SITES = [(8, 16, 16, 128, 128), (8, 32, 32, 512, 256),
                     (8, 64, 64, 512, 256), (8, 128, 128, 128, 128),
                     (8, 128, 128, 256, 256), (8, 256, 256, 128, 128),
                     (8, 256, 256, 256, 128)]
NCSNPP_NORM_SITES = [(8, 32, 32, 512), (8, 64, 64, 512), (8, 128, 128, 384),
                     (8, 256, 256, 128), (8, 256, 256, 256)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', NCSNPP_CONV_SITES)
def test_conv3x3_ncsnpp_sites_forward_and_backward(card, shape, dtype):
  """K1, its data gradient (K1 on the flipped kernel) and the weight and
  bias gradients at NCSN++'s sites against autograd through the plain
  version."""
  x, w, b = _conv_inputs(card, shape, dtype)
  B, H, W, cin, cout = shape
  dy = torch.randn((B, H, W, cout), generator=card, device='cuda').to(dtype)
  got_args = [t.detach().requires_grad_() for t in (x, w, b)]
  y = k1.conv3x3(*got_args)
  got = torch.autograd.grad(y, got_args, dy)
  want_args = [t.detach().requires_grad_() for t in (x, w, b)]
  want_y = k1.conv3x3_plain(*want_args)
  want = torch.autograd.grad(want_y, want_args, dy)
  assert _rel(y.detach(), want_y.detach()) <= TOL[dtype]
  for g, w_ in zip(got, want):
    assert _rel(g, w_) <= TOL[dtype]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', NCSNPP_NORM_SITES)
def test_groupnorm_act_ncsnpp_sites_forward_and_backward(card, shape,
                                                         dtype):
  """K2 and its recomputed backward at NCSN++'s sites against autograd
  through the plain version; the 256x256 images take the re-read plan."""
  H, W, C = shape[1:]
  if H == 256:
    assert not k2.groupnorm_plan(H, W, C, 32, torch.tensor(
        [], dtype=dtype).element_size())['on_chip']
  x = (torch.randn(shape, generator=card, device='cuda') * 2 + 3).to(dtype)
  scale = 1 + 0.1 * torch.randn((C,), generator=card, device='cuda')
  bias = 0.1 * torch.randn((C,), generator=card, device='cuda')
  dy = torch.randn(shape, generator=card, device='cuda').to(dtype)
  outs = []
  for fn in (k2.groupnorm_act, k2.groupnorm_act_plain):
    args = [t.detach().requires_grad_() for t in (x, scale, bias)]
    y = fn(*args, 32, 'silu')
    outs.append([y.detach()] + list(torch.autograd.grad(y, args, dy)))
  for got, want in zip(*outs):
    assert _rel(got, want) <= TOL[dtype]


def _ncsnpp(kernels, dtype):
  """ve/cifar10_ncsnpp_continuous cut to nf 64, ch_mult (1, 2), 1 res
  block, attention at 8x8, 16x16x3, every parameter randomised."""
  from b_pinn_kalman_filter_tpu_torch import configs
  from b_pinn_kalman_filter_tpu_torch.models import registry
  config = configs.get_config('ve/cifar10_ncsnpp_continuous')
  config.model.nf, config.model.ch_mult = 64, (1, 2)
  config.model.num_res_blocks, config.model.attn_resolutions = 1, (8,)
  config.data.image_size = 16
  config.tpu.compute_dtype = {torch.float32: 'float32',
                              torch.bfloat16: 'bfloat16'}[dtype]
  model = registry.create_model(config, device='cuda', kernels=kernels)
  g = torch.Generator().manual_seed(1)
  with torch.no_grad():
    for p in model.parameters():
      p.copy_(torch.randn(p.shape, generator=g).cuda() / (
          p[..., 0].numel() ** 0.5 if p.ndim >= 2 else 10.0))
  return config, model


@pytest.mark.parametrize('dtype', DTYPES)
def test_ncsnpp_forward_and_gradients_kernel_path_match_plain_path(card,
                                                                   dtype):
  """A cut NCSN++ (10 BigGAN resblocks: 20 K1 and 20 K2 sites) at batch
  4: the scores and the parameters' gradients of their squared sum,
  kernel path against plain path, with one K1 forward, one K1 data
  gradient and one K2 launch a site."""
  results = {}
  for kernels in (True, False):
    config, model = _ncsnpp(kernels, dtype)
    g = torch.Generator(device='cuda').manual_seed(2)
    x = torch.rand((4, 16, 16, 3), generator=g, device='cuda')
    sigmas = torch.tensor([0.02, 0.5, 5.0, 40.0], device='cuda')
    k1.conv3x3.launches_by_use.update(forward=0, data_grad=0, jvp=0)
    k2.groupnorm_act.launches = 0
    params = dict(model.named_parameters())
    y = model(x, sigmas, train=False)
    grads = torch.autograd.grad(y.square().sum(), list(params.values()),
                                allow_unused=True, materialize_grads=True)
    counts = dict(k1.conv3x3.launches_by_use,
                  groupnorm_act=k2.groupnorm_act.launches)
    results[kernels] = (y.detach(), grads, counts)
  (y, grads, counts), (y_plain, grads_plain, plain_counts) = (
      results[True], results[False])
  assert counts == dict(forward=20, data_grad=20, jvp=0, groupnorm_act=20)
  assert plain_counts == dict(forward=0, data_grad=0, jvp=0, groupnorm_act=0)
  assert torch.isfinite(y).all() and _rel(y, y_plain) <= TOL[dtype]
  top = max(float(g.abs().max()) for g in grads_plain)
  worst = max(float((a.float() - b.float()).abs().max()) / top
              for a, b in zip(grads, grads_plain))
  assert worst <= TOL[dtype]


# The DDPM high-resolution U-Net (vp/ddpm/{church,bedroom,celebahq}:
# ch_mult (1, 1, 2, 2, 4, 4), 512 channels at 16^2 and 8^2) at its batch
# 8 (cut from 64): K1 where its up path concatenates to 768 and 1024
# input channels, and K2 at 512 to 1024 channels, 32 groups.
DDPM_HIGHRES_CONV_SITES = [(8, 16, 16, 1024, 512), (8, 16, 16, 768, 512),
                           (8, 16, 16, 512, 512), (8, 16, 16, 256, 512),
                           (8, 8, 8, 1024, 512), (8, 8, 8, 512, 512)]
DDPM_HIGHRES_NORM_SITES = [(8, 16, 16, 1024), (8, 16, 16, 768),
                           (8, 16, 16, 512), (8, 8, 8, 1024), (8, 8, 8, 512)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', DDPM_HIGHRES_CONV_SITES)
def test_conv3x3_ddpm_highres_sites_forward_and_backward(card, shape,
                                                         dtype):
  test_conv3x3_ncsnpp_sites_forward_and_backward(card, shape, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', DDPM_HIGHRES_NORM_SITES)
def test_groupnorm_act_ddpm_highres_sites_forward_and_backward(card, shape,
                                                               dtype):
  test_groupnorm_act_ncsnpp_sites_forward_and_backward(card, shape, dtype)


@pytest.mark.parametrize('maxpool', [False, True])
def test_ncsn_crp_pooling_backward_matches_the_cpu(card, maxpool):
  """NCSN's chained residual pooling (5x5 stride-1 SAME pools) on the card
  against the CPU in f64: the gradients of x and of every parameter.
  ``F.avg_pool2d``'s backward of a permuted (channels-last) view with
  padding is wrong on the card, so the block pools a contiguous copy."""
  import copy
  import torch.nn.functional as F
  from b_pinn_kalman_filter_tpu_torch.models import layers, layers_ncsn
  block = layers_ncsn.CRPBlock(64, 2, F.elu, maxpool=maxpool)
  layers.init_params(block, torch.Generator().manual_seed(0))
  g = torch.Generator().manual_seed(1)
  x = torch.randn((4, 16, 16, 64), generator=g, dtype=torch.float64)
  dy = torch.randn((4, 16, 16, 64), generator=g, dtype=torch.float64)
  grads = []
  for device in ('cpu', 'cuda'):
    mod = copy.deepcopy(block).to(device, torch.float64)
    leaves = [x.to(device).requires_grad_()] + list(mod.parameters())
    y = mod(leaves[0])
    grads.append(torch.autograd.grad(y, leaves, dy.to(device)))
  for got, want in zip(grads[1], grads[0]):
    assert _rel(got.cpu(), want) <= 1e-10
