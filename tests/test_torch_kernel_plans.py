"""The port's kernel plans: which K1 kernel a conv takes, its pixel boxes and
split-K, K2's cluster, the K2 JVP kernel's cluster and ring, K3's tiles and
channel split, B1/B2's tiles, and which K4 kernel an image takes.  Pure
Python (no JAX, no compiler, no card).

The K1/K2 site shapes are those of the flagship U-Net
(``vp/cifar10_ddpmpp_continuous``, batch 8), counted from
``models/ddpm.py``: 79 K1 sites and 76 K2 sites.  The K3 shapes are the
five FlowNet levels of ``pinn/pinn_pde`` with its 8 B-PINN draws folded
into the batch; K4's image is the UKF's 64x64.
"""

import math

import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from b_pinn_kalman_filter_tpu_torch.ops import ns_step as k4

BATCH = 8
# (H, Cin, Cout): number of sites per forward.
CONV_SITES = {
    (32, 128, 128): 13, (32, 256, 128): 4, (32, 384, 128): 1,
    (32, 256, 256): 1,
    (16, 128, 256): 1, (16, 256, 256): 13, (16, 512, 256): 4,
    (16, 384, 256): 1,
    (8, 256, 256): 14, (8, 512, 256): 5,
    (4, 256, 256): 17, (4, 512, 256): 5,
}
SITES = sorted(CONV_SITES)
# (H, C): the GroupNorm+SiLU sites' shapes (G = 32).
NORM_SHAPES = [(32, 128), (32, 256), (32, 384), (16, 128), (16, 256),
               (16, 384), (16, 512), (8, 256), (8, 512), (4, 256), (4, 512)]


def test_site_table_counts_79_convs():
  assert sum(CONV_SITES.values()) == 79
  assert sum(n for (h, _, _), n in CONV_SITES.items() if h <= 8) == 41


@pytest.mark.parametrize('site', SITES)
def test_main_path_bf16_sites_take_the_wgmma_kernel(site):
  _, cin, cout = site
  assert k1.kernel_for(torch.bfloat16, cin, cout) == 'wgmma'
  assert k1.kernel_for(torch.float32, cin, cout) == 'direct'


@pytest.mark.parametrize('dtype,cin,cout,want', [
    (torch.float32, 128, 128, 'direct'),     # TF32 would miss 1e-4
    (torch.bfloat16, 3, 128, 'direct'),      # Cin % 8: no 16-byte stride
    (torch.bfloat16, 36, 64, 'direct'),
    (torch.bfloat16, 64, 3, 'direct'),       # Cout % 8
    (torch.bfloat16, 40, 72, 'wgmma'),       # ragged against 64, but % 8
    (torch.bfloat16, 32, 32, 'wgmma'),
])
def test_dispatch_rule(dtype, cin, cout, want):
  assert k1.kernel_for(dtype, cin, cout) == want


def _coverage(B, H, W):
  """How often each pixel of (B, H, W) lies in a tile's box."""
  bb, hb, wb = k1.wgmma_box(B, H, W)
  seen = np.zeros((B, H, W), dtype=int)
  for b0 in range(0, B, bb):
    for h0 in range(0, H, hb):
      for w0 in range(0, W, wb):
        seen[b0:b0 + bb, h0:h0 + hb, w0:w0 + wb] += 1
  return seen


@pytest.mark.parametrize('bhw', [(BATCH, 32, 32), (BATCH, 16, 16),
                                 (BATCH, 8, 8), (BATCH, 4, 4), (3, 7, 9),
                                 (1, 1, 1), (2, 100, 3), (1, 5, 130)])
def test_boxes_cover_each_pixel_once(bhw):
  B, H, W = bhw
  bb, hb, wb = k1.wgmma_box(B, H, W)
  assert bb * hb * wb == k1.WGMMA_BM
  assert all(d & (d - 1) == 0 for d in (bb, hb, wb))
  assert (_coverage(B, H, W) == 1).all()
  plan = k1.wgmma_plan(B, H, W, 64, 64)
  assert plan['tiles_m'] == (math.ceil(B / bb) * math.ceil(H / hb)
                             * math.ceil(W / wb))


def test_boxes_are_whole_rows_on_the_main_path():
  assert k1.wgmma_box(BATCH, 32, 32) == (1, 2, 32)
  assert k1.wgmma_box(BATCH, 16, 16) == (1, 4, 16)
  assert k1.wgmma_box(BATCH, 8, 8) == (1, 8, 8)
  assert k1.wgmma_box(BATCH, 4, 4) == (4, 4, 4)


@pytest.mark.parametrize('site', SITES)
def test_split_k_fills_the_card(site):
  H, cin, cout = site
  plan = k1.wgmma_plan(BATCH, H, H, cin, cout)
  assert plan['bn'] in (64, 128) and 1 <= plan['split'] <= k1.MAX_SPLIT
  assert plan['blocks'] == (plan['tiles_m'] * plan['tiles_n']
                            * plan['split'])
  assert plan['tiles_n'] * plan['bn'] >= cout
  # Every split has K steps to run, and the small levels fill half the SMs.
  assert plan['k_steps'] >= k1.MIN_STEPS_PER_SPLIT * plan['split']
  if H <= 8:
    assert plan['split'] > 1 and plan['blocks'] >= 64
  else:
    assert plan['blocks'] >= 64


@pytest.mark.parametrize('hc', NORM_SHAPES)
def test_groupnorm_cluster_keeps_main_path_images_on_chip(hc):
  H, C = hc
  for itemsize in (2, 4):
    plan = k2.groupnorm_plan(H, H, C, 32, itemsize)
    cluster = plan['cluster']
    assert cluster in (1, 2, 4, 8)
    # Split only while every block keeps MIN_SLICE_BYTES of the image.
    image = H * H * C * itemsize
    assert cluster == 1 or image // cluster >= k2.MIN_SLICE_BYTES
    assert cluster == k2.MAX_CLUSTER or image // (2 * cluster) < (
        k2.MIN_SLICE_BYTES)
    if H == 32:
      assert cluster == k2.MAX_CLUSTER
    assert plan['vec'] * itemsize == 16 and C % plan['vec'] == 0
    assert 1 <= plan['q'] <= plan['threads']
    assert plan['threads'] == (k2.SMALL_THREADS if plan['slice_bytes'] <= (
        k2.MIN_SLICE_BYTES) else k2.THREADS)
    assert plan['smem_bytes'] <= k2.SMEM_LIMIT
    if itemsize == 2:
      assert plan['on_chip']


@pytest.mark.parametrize('shape,itemsize,want', [
    # (H, W, C, G): cluster, vec, on_chip
    ((64, 64, 512, 32), 2, (8, 8, False)),   # 4 MB: larger than a cluster
    ((5, 7, 24, 8), 2, (1, 8, True)),        # cg = 3, 48-byte pixel rows
    ((5, 7, 24, 8), 4, (1, 4, True)),
    ((48, 48, 24, 8), 2, (4, 8, True)),      # the same, over a cluster
    ((4, 4, 30, 6), 2, (1, 1, True)),        # 60-byte rows: scalar loads
    ((40, 40, 30, 6), 2, (4, 1, True)),
    ((2, 2, 4096, 32), 4, (4, 4, True)),     # 64 KB: one pixel a block
    ((1, 1, 8, 4), 2, (1, 8, True)),
])
def test_groupnorm_plan_edges(shape, itemsize, want):
  plan = k2.groupnorm_plan(*shape, itemsize)
  assert (plan['cluster'], plan['vec'], plan['on_chip']) == want
  H, W = shape[:2]
  assert plan['cluster'] <= H * W


@pytest.mark.parametrize('hc', NORM_SHAPES)
def test_groupnorm_jvp_plan_fits_two_blocks_an_sm(hc):
  """The K2 JVP kernel's plan at every main-path site, batches 8 and 256
  (the bits/dim batch), bf16 and f32: two blocks fit on an SM (each with
  the card's 1 KB of reserved shared memory); a cluster of up to 8 whose
  blocks cover every pixel once, the least that keeps the slices on chip;
  the ring's chunks cover a block's pixels; the grid is cluster x B."""
  H, C = hc
  for batch in (8, 256):
    for itemsize in (2, 4):
      plan = k2.jvp_plan(H, H, C, 32, itemsize, batch)
      P = H * H
      assert plan['smem_bytes'] <= k2.JVP_BLOCK_SMEM <= k2.SMEM_LIMIT
      assert 2 * (plan['smem_bytes'] + k2.BLOCK_RESERVED) <= k2.SM_SMEM
      cluster = plan['cluster']
      assert cluster in (1, 2, 4, 8)
      budget = k2.JVP_BLOCK_SMEM - plan['head_bytes']
      stage = -(-plan['chunk_rows'] * C * itemsize // 128) * 128
      assert plan['smem_bytes'] == plan['head_bytes'] + 2 * plan[
          'stages'] * stage <= k2.JVP_BLOCK_SMEM
      assert plan['on_chip'] == (2 * plan['chunks'] * stage <= budget)
      assert cluster == k2.MAX_CLUSTER or plan['on_chip']
      # The least cluster whose ring holds a block's slices; more blocks
      # only while the grid stays within a wave and a block keeps
      # MIN_SLICE_BYTES of x and dx.
      fits = []
      for c in (1, 2, 4, 8):
        rows = -(-P // c)
        chunk = min(rows, k2.JVP_CHUNK_BYTES // (C * itemsize))
        fits.append(2 * -(-rows // chunk) * (
            -(-chunk * C * itemsize // 128) * 128) <= budget)
      least = next((c for c, f in zip((1, 2, 4, 8), fits) if f), 8)
      assert cluster >= least
      if cluster > least:
        assert batch * cluster <= k2.NUM_SMS
        assert 2 * C * itemsize * -(-P // cluster) >= k2.MIN_SLICE_BYTES
      rows = plan['rows']
      assert rows * cluster >= P > rows * (cluster - 1)
      assert plan['chunks'] * plan['chunk_rows'] >= rows
      assert plan['chunk_rows'] * C * itemsize <= k2.JVP_CHUNK_BYTES
      assert 1 <= plan['stages'] <= min(plan['chunks'], k2.JVP_MAX_STAGES)
      assert plan['on_chip'] == (plan['stages'] == plan['chunks'])
      assert plan['vec'] * itemsize == 16 and plan['q'] == C // plan['vec']
      assert plan['q'] * plan['rows_in_flight'] <= k2.JVP_THREADS
      assert plan['blocks'] == cluster * batch
      # In bf16 the slices stay on chip at every site but 32x32x256 and
      # 32x32x384, whose images exceed 8 blocks' rings.
      if itemsize == 2:
        assert plan['on_chip'] == (H < 32 or C == 128)


# (B, H, W, C) of the cost volume on the ukf path: 8 draws x batch 1.
CORR_LEVELS = [(8, 32, 32, 16), (8, 16, 16, 32), (8, 8, 8, 64), (8, 4, 4, 96),
               (8, 2, 2, 128)]
CORR_ODD = [(3, 13, 7, 3), (1, 1, 1, 1), (2, 5, 9, 1), (2, 11, 19, 40),
            (1, 5, 130, 8), (129, 64, 64, 8), (1, 32, 32, 16), (2, 37, 6, 12)]


@pytest.mark.parametrize('shape', CORR_LEVELS + CORR_ODD)
def test_correlation_tiles_cover_the_image_and_no_more(shape):
  B, H, W, C = shape
  plan = k3.correlation_plan(*shape)
  th, tw, strip = plan['th'], plan['tw'], plan['strip']
  # Tiles divide the image, so no block computes a pixel outside it.
  assert H % th == 0 and W % tw == 0 and tw % strip == 0
  seen = np.zeros((H, W), dtype=int)
  for y0 in range(0, H, th):
    for x0 in range(0, W, tw):
      seen[y0:y0 + th, x0:x0 + tw] += 1
  assert (seen == 1).all()
  assert plan['tiles'] == (H // th) * (W // tw)
  assert plan['threads'] == 7 * th * (tw // strip) <= k3.MAX_THREADS
  assert plan['blocks'] == B * plan['tiles'] * plan['split']
  assert plan['smem_bytes'] <= k3.SMEM_LIMIT
  # 16-byte shared loads per FMA: (2 strip + 6) per 4 channels x 7 strip.
  assert (2 * strip + 6) / (28 * strip) <= 0.5
  assert plan['vec'] == int(C % 4 == 0)


@pytest.mark.parametrize('shape', CORR_LEVELS + CORR_ODD)
def test_correlation_split_covers_every_channel_once(shape):
  B, H, W, C = shape
  plan = k3.correlation_plan(*shape)
  split, cs = plan['split'], plan['cs']
  assert split in (1, 2, 4, 8)
  owner = np.zeros(C, dtype=int)
  for rank in range(split):
    lo, hi = rank * cs, min(C, (rank + 1) * cs)
    assert lo < hi                       # no rank without channels
    owner[lo:hi] += 1
  assert (owner == 1).all()
  if split > 1:                          # 16-byte vectors, 2 at least
    assert cs % 4 == 0 and cs >= k3.MIN_RANK_CHANNELS
  assert plan['stages'] == (2 if cs > k3.CHUNK else 1)


def test_correlation_plan_on_the_ukf_path():
  """Every folded level fills half the card or more: the small levels by
  splitting their channels over clusters."""
  got = [(k3.correlation_plan(*s)['strip'], k3.correlation_plan(*s)['split'],
          k3.correlation_plan(*s)['blocks']) for s in CORR_LEVELS]
  assert got == [(4, 1, 64), (4, 2, 64), (2, 4, 64), (1, 8, 64), (1, 8, 64)]


# K3's backward (B1, B2) at the five FlowNet levels at batch 8 (the ukf's
# draws) and 64 (a PINN train step), and at odd shapes.
BWD_SHAPES = ([(b,) + level[1:] for b in (8, 64) for level in CORR_LEVELS]
              + [(3, 13, 11, 24), (2, 11, 19, 40), (2, 5, 9, 1),
                 (2, 5, 7, 3), (1, 1, 1, 1)])


@pytest.mark.parametrize('shape', BWD_SHAPES)
def test_correlation_bwd_plan_tiles_the_image_and_fits_two_blocks(shape):
  """B1's and B2's plan: a tile that divides the image (each output pixel
  computed by one block), channels split into equal runs of 16-byte
  vectors, at most 256 threads, two blocks an SM (B2's halo of d is the
  larger), and the grid's block count."""
  B, H, W, C = shape
  plan = k3.correlation_bwd_plan(*shape)
  th, tw, strip = plan['th'], plan['tw'], plan['strip']
  assert H % th == 0 and W % tw == 0 and tw % strip == 0
  assert strip == (4 if W % 4 == 0 else 2 if W % 2 == 0 else 1)
  split, cs = plan['split'], plan['cs']
  assert cs * split == C and (split == 1 or cs % 4 == 0)
  assert plan['threads'] == th * (tw // strip) * -(-cs // 4)
  assert 1 <= plan['threads'] <= k3.MAX_THREADS
  assert plan['smem_bytes'] == k3._bwd_smem(th, tw, strip, cs)
  assert plan['smem_bytes'] <= k3.BWD_SMEM_BUDGET < k3.SMEM_LIMIT // 2
  assert plan['tiles'] == (H // th) * (W // tw)
  assert plan['blocks'] == B * plan['tiles'] * split
  assert plan['vec'] == int(C % 4 == 0)


def test_correlation_bwd_plan_on_the_pinn_path():
  """At the FlowNet's levels the plan splits no channels.  At batch 64
  the three largest levels take the largest blocks whose grid covers the
  card's 132 SMs (256 blocks each), the two smallest a block an image; at
  batch 8 no grid covers the card and the blocks keep near 128 threads
  (96 and 64 at 4x4x96 and 2x2x128, whose channels allow no more)."""
  for batch, blocks, threads in (
      (64, [256, 256, 256, 64, 64], [256, 128, 64, 96, 64]),
      (8, [64, 32, 16, 8, 8], [128, 128, 128, 96, 64])):
    plans = [k3.correlation_bwd_plan(batch, *level[1:])
             for level in CORR_LEVELS]
    assert [p['blocks'] for p in plans] == blocks
    assert [p['threads'] for p in plans] == threads
    assert all(p['split'] == 1 for p in plans)


@pytest.mark.parametrize('shape,want', [
    ((129, 64, 64), ('smem', 1)),     # the UKF's 129 sigma points: one wave
    ((1, 64, 64), ('smem', 8)),       # the rollout's image over 8 SMs
    ((33, 64, 64), ('smem', 4)),
    ((3, 13, 7), ('smem', 1)),        # odd H: no split
    ((2, 2, 2), ('smem', 2)),         # a row a block
    ((1, 76, 76), ('smem', 4)),       # the largest square one block holds
    ((1, 77, 77), ('staged', 1)),
    ((2, 128, 128), ('staged', 1)),
])
def test_ns_step_plan_keeps_an_image_on_chip_where_it_fits(shape, want):
  B, H, W = shape
  plan = k4.ns_step_plan(*shape)
  assert (plan['kernel'], plan['cluster']) == want
  image = k4.SMEM_FIELDS * H * W * 4
  assert (image <= k4.SMEM_LIMIT) == (plan['kernel'] == 'smem')
  if plan['kernel'] == 'smem':
    cluster = plan['cluster']
    assert H % cluster == 0 and B * cluster <= max(k4.NUM_SMS, B)
    assert plan['smem_bytes'] == image // cluster <= k4.SMEM_LIMIT
    assert plan['vec'] == int(cluster == 1 and H * W % 4 == 0
                              and H * W >= 4 * k4.THREADS)
