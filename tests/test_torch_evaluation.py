"""The port's FID/KID/IS and feature extractors (``train/evaluation.py``,
``train/inception.py``) against the JAX package's.

- FID, KID and IS on seeded numpy features: 1e-10 relative (the same
  float64 numpy code).
- The random-feature proxy with JAX's ``PRNGKey(2023)`` weights carried
  across (``models/convert.py`` ``random_proxy_from_jax``), on 32x32x3 and
  on an odd 9x7x1 image (XLA's 'SAME' padding puts the odd pixel at the
  end): 1e-5 of max |JAX| (f32 convolutions in another order).
- The InceptionV3 forward at batch 1 from a 32x32 image (the 299^2 resize
  included) under the port's ``random_inception_params``, handed to JAX's
  ``inception_forward``: 1e-5 of max |JAX|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.train import evaluation as jax_eval
from b_pinn_kalman_filter_tpu.train import inception as jax_inception
from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.models import convert
from b_pinn_kalman_filter_tpu_torch.train import evaluation, inception
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-5


def _rel(got, want):
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _feats(n, d, seed, shift=0.0):
  return (np.random.default_rng(seed).standard_normal((n, d)) + shift
          ).astype(np.float32)


@pytest.mark.parametrize('n1,n2,d,block', [(40, 30, 8, 4096), (40, 30, 8, 7),
                                           (64, 50, 16, 16)])
def test_fid_and_kid_match_jax(n1, n2, d, block):
  a, b = _feats(n1, d, 1), _feats(n2, d, 2, shift=0.3)
  assert abs(evaluation.frechet_distance(a, b)
             - jax_eval.frechet_distance(a, b)) <= 1e-10 * abs(
                 jax_eval.frechet_distance(a, b))
  want = jax_eval.kernel_distance(a, b, block=block)
  assert abs(evaluation.kernel_distance(a, b, block=block) - want) <= (
      1e-10 * abs(want))
  # The blocked sums equal the one-block ones.
  assert abs(evaluation.kernel_distance(a, b, block=block)
             - evaluation.kernel_distance(a, b)) <= 1e-10 * abs(want)
  assert evaluation.frechet_distance(a, a) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize('splits', [1, 3, 10])
def test_inception_score_matches_jax(splits):
  logits = _feats(37, 11, 3) * 3
  assert evaluation.inception_score(logits, splits) == pytest.approx(
      jax_eval.inception_score(logits, splits), rel=1e-12)


def _jax_proxy_weights(shape, feature_dim=256, logits_dim=64):
  """The weights ``jax_eval.make_random_feature_fn(PRNGKey(2023), shape)``
  closes over, drawn as it draws them."""
  c = shape[2]
  k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(2023), 4)
  return (jax.random.normal(k1, (3, 3, c, 32)) / np.sqrt(9 * c),
          jax.random.normal(k2, (3, 3, 32, 64)) / np.sqrt(9 * 32),
          jax.random.normal(k3, (3, 3, 64, feature_dim)) / np.sqrt(9 * 64),
          jax.random.normal(k4, (feature_dim, logits_dim))
          / np.sqrt(feature_dim))


@pytest.mark.parametrize('shape', [(32, 32, 3), (9, 7, 1)])
def test_random_proxy_with_jax_weights_matches_jax(shape):
  images = np.random.default_rng(4).random((5,) + shape).astype(np.float32)
  want_pool, want_logits = jax_eval.make_random_feature_fn(
      jax.random.PRNGKey(2023), shape)(jnp.asarray(images))
  weights = convert.random_proxy_from_jax(_jax_proxy_weights(shape))
  fn = evaluation.make_random_feature_fn(shape, weights=weights,
                                         device='cpu')
  pool, logits = fn(images)
  assert pool.shape == (5, 256) and logits.shape == (5, 64)
  assert _rel(pool, want_pool) <= TOL
  assert _rel(logits, want_logits) <= TOL
  # Chunks give the same features as one call.
  chunked = fn(images, batch=2)
  np.testing.assert_allclose(chunked[0], pool, rtol=1e-6, atol=1e-7)


def test_seeded_proxy_and_extractor_labels(tmp_path, monkeypatch):
  """The seeded proxy is the same on every call; ``get_feature_extractor``
  gives the JAX package's labels; ``load_dataset_stats`` caches under the
  JAX tag."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path / 'data'))
  monkeypatch.delenv('BPKF_INCEPTION_WEIGHTS', raising=False)
  monkeypatch.delenv('BPKF_INCEPTION_RANDOM_INIT', raising=False)
  config = configs.get_config('vp/cifar10_ddpmpp_continuous')
  config.data.image_size = 8
  images = np.random.default_rng(5).random((6, 8, 8, 3)).astype(np.float32)
  fn, source = evaluation.get_feature_extractor(config, device='cpu')
  assert source == 'random_proxy'
  again, _ = evaluation.get_feature_extractor(config, device='cpu')
  np.testing.assert_array_equal(fn(images)[0], again(images)[0])
  loader = [(images[:4], np.zeros(4)), (images[4:], np.zeros(2))]
  feats = evaluation.load_dataset_stats(config, loader, fn, source,
                                        str(tmp_path / 'assets'),
                                        max_images=5)
  assert feats.shape == (5, 256)
  assert os.path.exists(tmp_path / 'assets' /
                        'dataset_feats_CIFAR10_8_3_random_proxy_5.npz')
  cached = evaluation.load_dataset_stats(config, [], fn, source,
                                         str(tmp_path / 'assets'),
                                         max_images=5)
  np.testing.assert_array_equal(cached, feats)
  metrics = evaluation.compute_metrics(fn, images[:3], images[3:])
  assert set(metrics) == {'fid', 'kid', 'inception_score'}
  assert all(np.isfinite(v) for v in metrics.values())
  config.eval.inception_random_init = True
  _, source = evaluation.get_feature_extractor(config, device='cpu')
  assert source == 'inception_v3_random_proxy'


def test_inception_forward_matches_jax():
  params = inception.random_inception_params(torch.Generator().manual_seed(3))
  image = np.random.default_rng(6).random((1, 32, 32, 3)).astype(np.float32)
  want_pool, want_logits = jax.jit(
      lambda x: jax_inception.inception_forward(params, x))(
          jnp.asarray(image))
  pool, logits = inception.inception_forward(
      convert.inception_params_from_jax(params), torch.from_numpy(image))
  assert pool.shape == (1, 2048) and logits.shape == (1, 1000)
  assert _rel(pool.numpy(), want_pool) <= TOL
  assert _rel(logits.numpy(), want_logits) <= TOL


def test_inception_weights_load_only_from_disk(tmp_path, monkeypatch):
  """No file: None.  A converted ``.npz`` and a torchvision-style
  state_dict ``.pth`` (BN folded as the JAX package folds it) load."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path))
  monkeypatch.delenv('BPKF_INCEPTION_WEIGHTS', raising=False)
  assert inception.load_inception_params() is None
  params = inception.random_inception_params(torch.Generator().manual_seed(4))
  inception.save_params_npz(params, str(tmp_path / 'inception_v3.npz'))
  loaded = inception.load_inception_params()
  assert set(loaded) == set(params)
  np.testing.assert_array_equal(loaded['fc'][0], params['fc'][0])
  os.unlink(tmp_path / 'inception_v3.npz')

  rng = np.random.default_rng(7)
  sd = {}
  for name, k, cin, cout, _, _ in inception.CONV_SPEC:
    sd[f'{name}.conv.weight'] = torch.from_numpy(
        rng.standard_normal((cout, cin) + k).astype(np.float32))
    sd[f'{name}.bn.weight'] = torch.from_numpy(
        1 + 0.1 * rng.standard_normal(cout).astype(np.float32))
    sd[f'{name}.bn.bias'] = torch.from_numpy(
        rng.standard_normal(cout).astype(np.float32))
    sd[f'{name}.bn.running_mean'] = torch.from_numpy(
        rng.standard_normal(cout).astype(np.float32))
    sd[f'{name}.bn.running_var'] = torch.from_numpy(
        rng.random(cout).astype(np.float32) + 0.5)
  sd['fc.weight'] = torch.zeros((1000, 2048))
  sd['fc.bias'] = torch.zeros(1000)
  torch.save(sd, tmp_path / 'weights.pth')
  monkeypatch.setenv('BPKF_INCEPTION_WEIGHTS', str(tmp_path / 'weights.pth'))
  got = inception.load_inception_params()
  want = jax_inception.params_from_torch_state_dict(sd)
  for name in ('Conv2d_1a_3x3', 'Mixed_7c.branch_pool'):
    for g, w in zip(got[name], want[name]):
      np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
