"""Sample-quality metrics (FID, KID, Inception Score) and their feature
extractors.

Counterpart of the JAX package's ``train/evaluation.py``.  The metrics are
its numpy float64 code, copied.  The feature extractors:

- the InceptionV3 of ``train/inception.py`` where weights are on disk
  (label ``inception_v3``), or with ``eval.inception_random_init`` (or
  ``$BPKF_INCEPTION_RANDOM_INIT``) the same architecture under seeded
  random weights (label ``inception_v3_random_proxy``);
- else the frozen random-feature CNN, :func:`make_random_feature_fn`
  (label ``random_proxy``): three stride-2 3x3 convs with GELU, a mean
  pool and a linear layer.  These convs are XLA convolutions in JAX, not
  a Pallas kernel, so ``F.conv2d`` carries them here.

The port's random weights come from a ``torch.Generator`` seeded with
2023 where JAX's come from ``PRNGKey(2023)``: the same label, other
numbers.  Metrics over either proxy are self-consistent across runs of one
package, not comparable with published Inception-based scores nor across
the two packages (the tests carry JAX's weights across to compare).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.train import inception

PROXY_SEED = 2023

# ---------------------------------------------------------------------------
# Metrics (exact math, numpy float64)
# ---------------------------------------------------------------------------


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
  """Matrix square root of a PSD matrix via symmetric eigendecomposition."""
  vals, vecs = np.linalg.eigh(mat)
  vals = np.clip(vals, 0, None)
  return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(feats1: np.ndarray, feats2: np.ndarray) -> float:
  """FID between two feature sets (N1, D), (N2, D)."""
  feats1 = np.asarray(feats1, np.float64)
  feats2 = np.asarray(feats2, np.float64)
  mu1, mu2 = feats1.mean(0), feats2.mean(0)
  s1 = np.cov(feats1, rowvar=False)
  s2 = np.cov(feats2, rowvar=False)
  diff = mu1 - mu2
  # tr sqrt(S1 S2) computed stably: sqrt(S1) S2 sqrt(S1) is PSD.
  rs1 = _sqrtm_psd(s1)
  covmean = _sqrtm_psd(rs1 @ s2 @ rs1)
  return float(diff @ diff + np.trace(s1) + np.trace(s2)
               - 2 * np.trace(covmean))


def kernel_distance(feats1: np.ndarray, feats2: np.ndarray,
                    degree: int = 3, gamma: Optional[float] = None,
                    coef0: float = 1.0, block: int = 4096) -> float:
  """KID: the unbiased polynomial-kernel MMD^2 between feature sets,
  exact but summed over blocks of ``block`` rows (O(block^2) memory)."""
  x = np.asarray(feats1, np.float64)
  y = np.asarray(feats2, np.float64)
  if gamma is None:
    gamma = 1.0 / x.shape[1]

  def k(a, b):
    return (gamma * a @ b.T + coef0) ** degree

  def gram_sum(a, b):
    total = 0.0
    for i in range(0, a.shape[0], block):
      for j in range(0, b.shape[0], block):
        total += k(a[i:i + block], b[j:j + block]).sum()
    return total

  def gram_sum_sym(a):
    # The j >= i block pairs, the off-diagonal ones twice.
    total = 0.0
    for i in range(0, a.shape[0], block):
      for j in range(i, a.shape[0], block):
        s = k(a[i:i + block], a[j:j + block]).sum()
        total += s if j == i else 2.0 * s
    return total

  def diag_sum(a):
    return float((gamma * (a * a).sum(axis=1) + coef0).__pow__(degree).sum())

  n, m = x.shape[0], y.shape[0]
  sum_xx = (gram_sum_sym(x) - diag_sum(x)) / (n * (n - 1))
  sum_yy = (gram_sum_sym(y) - diag_sum(y)) / (m * (m - 1))
  sum_xy = gram_sum(x, y) / (n * m)
  return float(sum_xx + sum_yy - 2 * sum_xy)


def inception_score(logits: np.ndarray, splits: int = 10) -> float:
  """IS from classifier logits (N, C): exp(E_x KL(p(y|x) || p(y)))."""
  logits = np.asarray(logits, np.float64)
  probs = np.exp(logits - logits.max(-1, keepdims=True))
  probs /= probs.sum(-1, keepdims=True)
  scores = []
  for part in np.array_split(probs, splits):
    if len(part) == 0:
      continue
    py = part.mean(0, keepdims=True)
    kl = (part * (np.log(part + 1e-12) - np.log(py + 1e-12))).sum(-1)
    scores.append(np.exp(kl.mean()))
  return float(np.mean(scores))


# ---------------------------------------------------------------------------
# Feature extractors
# ---------------------------------------------------------------------------


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """XLA's 'SAME' padding of one spatial axis: (low, high), the odd pixel
  at the end."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def random_proxy_weights(image_shape: Tuple[int, int, int],
                         feature_dim: int = 256, logits_dim: int = 64,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[np.ndarray, ...]:
  """(w1, w2, w3, w4) of the random-feature CNN: three HWIO 3x3 kernels
  (C -> 32 -> 64 -> ``feature_dim``) and the (feature_dim, logits_dim)
  head, standard normals over the square root of the fan-in, from
  ``generator`` (default seeded with ``PROXY_SEED``)."""
  if generator is None:
    generator = torch.Generator().manual_seed(PROXY_SEED)
  c = image_shape[2]
  shapes = ((3, 3, c, 32), (3, 3, 32, 64), (3, 3, 64, feature_dim),
            (feature_dim, logits_dim))
  return tuple((torch.randn(s, generator=generator, dtype=torch.float32)
                / np.sqrt(np.prod(s[:-1]))).numpy() for s in shapes)


def make_random_feature_fn(image_shape: Tuple[int, int, int],
                           feature_dim: int = 256, logits_dim: int = 64, *,
                           weights: Optional[Sequence[np.ndarray]] = None,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> Callable:
  """The frozen random CNN feature extractor (the hermetic FID proxy):
  ``feature_fn(images (B, H, W, C) in [0, 1], batch=1024) -> (pool (B, D),
  logits (B, L))``, numpy float32, computed on ``device`` in chunks of
  ``batch``.  ``weights`` (numpy, as :func:`random_proxy_weights` gives
  them; the tests carry JAX's across), else drawn from ``generator``."""
  device = get_device(device)
  if weights is None:
    weights = random_proxy_weights(image_shape, feature_dim, logits_dim,
                                   generator)
  w1, w2, w3, w4 = (torch.tensor(np.asarray(w, np.float32), device=device)
                    for w in weights)
  convs = [w.permute(3, 2, 0, 1).contiguous() for w in (w1, w2, w3)]

  @torch.no_grad()
  def fwd(images: torch.Tensor):
    h = images.permute(0, 3, 1, 2) * 2.0 - 1.0
    for w in convs:
      pad_h = same_pads(h.shape[2], 3, 2)
      pad_w = same_pads(h.shape[3], 3, 2)
      h = F.conv2d(F.pad(h, pad_w + pad_h), w, stride=2)
      h = F.gelu(h, approximate='tanh')     # jax.nn.gelu's default
    pool = h.mean(dim=(2, 3))
    return pool, pool @ w4

  def feature_fn(images, batch: int = 1024):
    return inception.chunked(fwd, images, batch, device)

  return feature_fn


def get_feature_extractor(config=None, *, device=None
                          ) -> Tuple[Callable, str]:
  """``(feature_fn, source)``, source one of ``inception_v3``,
  ``inception_v3_random_proxy`` and ``random_proxy`` (see the module
  docstring); ``feature_fn(images (B, H, W, C) in [0, 1]) -> (pool
  features, logits)``."""
  params = inception.load_inception_params()
  if params is not None:
    return (inception.make_inception_feature_fn(params, device=device),
            'inception_v3')
  random_init = (config is not None and 'eval' in config
                 and config.eval.get('inception_random_init', False))
  if random_init or os.environ.get('BPKF_INCEPTION_RANDOM_INIT'):
    params = inception.random_inception_params(
        torch.Generator().manual_seed(PROXY_SEED))
    return (inception.make_inception_feature_fn(params, device=device),
            'inception_v3_random_proxy')
  logging.getLogger(__name__).warning(
      'No InceptionV3 weights found; FID/KID/IS use RANDOM-FEATURE PROXY '
      'values (not comparable to published Inception metrics).')
  shape = ((config.data.image_size, config.data.image_size,
            config.data.num_channels) if config is not None else (32, 32, 3))
  return make_random_feature_fn(shape, device=device), 'random_proxy'


def load_dataset_stats(config, eval_ds, feature_fn: Callable, source: str,
                       stats_dir: str, max_images: int = 2048) -> np.ndarray:
  """The reference set's pool features: the first ``max_images`` images
  of ``eval_ds`` through ``feature_fn``, cached in ``stats_dir`` under the
  JAX package's tag (dataset, size, channels, source, ``max_images``)."""
  os.makedirs(stats_dir, exist_ok=True)
  tag = (f'{config.data.dataset}_{config.data.image_size}'
         f'_{config.data.num_channels}_{source}_{max_images}')
  cache = os.path.join(stats_dir, f'dataset_feats_{tag}.npz')
  if os.path.exists(cache):
    return np.load(cache)['feats']
  images = []
  count = 0
  for item in iter(eval_ds):
    batch = item[0] if isinstance(item, tuple) else item
    images.append(np.asarray(batch, np.float32))
    count += len(images[-1])
    if count >= max_images:
      break
  images = np.concatenate(images)[:max_images]
  feats, _ = feature_fn(images)
  np.savez_compressed(cache, feats=feats)
  return feats


def compute_metrics(feature_fn: Callable, samples: np.ndarray,
                    reference: np.ndarray) -> dict:
  """FID, KID and IS between sample and reference image sets (both in
  [0, 1])."""
  sp, sl = feature_fn(samples)
  rp, _ = feature_fn(reference)
  return {
      'fid': frechet_distance(sp, rp),
      'kid': kernel_distance(sp, rp),
      'inception_score': inception_score(sl),
  }
