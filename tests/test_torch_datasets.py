"""The port's CIFAR-10 data path against the JAX package's
``data/datasets.py``: the synthetic stand-in, the loader's epoch
reshuffles and full batches, the native CIFAR-10 reader and
``get_dataset``, bit for bit from the same seeds."""

import itertools
import os
import pickle

import numpy as np
import pytest

from b_pinn_kalman_filter_tpu.data import datasets as jax_data
from b_pinn_kalman_filter_tpu_torch.data import datasets
from tests import port_parity


def _batches(loader, n):
  it = iter(loader)
  try:
    return list(itertools.islice(it, n))
  finally:
    it.close()


def _assert_same(got, want):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    for a, b in zip(g, w):
      assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize('n,batch,shuffle', [
    (10, 4, True),    # 2 batches an epoch (2 items dropped): 5 batches
                      # cross two epoch boundaries
    (3, 4, True),     # fewer items than a batch: epochs concatenated
    (10, 4, False),   # the eval loader's order
])
def test_loader_batches_equal_jax(n, batch, shuffle):
  port = datasets.NumpyLoader(datasets.SyntheticImages(n, 8, 3, seed=4),
                              batch, shuffle=shuffle, seed=7)
  ref = jax_data.NumpyLoader(jax_data.SyntheticImages(n, 8, 3, seed=4),
                             batch, shuffle=shuffle, seed=7)
  got, want = _batches(port, 5), _batches(ref, 5)
  _assert_same(got, want)
  assert len(got) == 5 and got[0][0].shape == (batch, 8, 8, 3)


def test_get_dataset_equals_jax_on_the_synthetic_stand_in(tmp_path,
                                                         monkeypatch):
  """No CIFAR-10 files under ``$BPKF_DATA_DIR``: both packages fall back to
  the same synthetic images in the same order, train and eval."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path))
  jax_config, torch_config = port_parity.tiny_configs()
  for config in (jax_config, torch_config):
    config.training.batch_size = 4
  port_train, port_eval = datasets.get_dataset(torch_config)
  ref_train, ref_eval = jax_data.get_dataset(jax_config)
  _assert_same(_batches(port_train, 3), _batches(ref_train, 3))
  _assert_same(_batches(port_eval, 2), _batches(ref_eval, 2))


def test_cifar10_reader_equals_jax(tmp_path, monkeypatch):
  """The ``cifar-10-batches-py`` pickles (a tiny fake set) read the same."""
  base = tmp_path / 'cifar-10-batches-py'
  base.mkdir()
  rng = np.random.default_rng(0)
  for name in [f'data_batch_{i}' for i in range(1, 6)] + ['test_batch']:
    with open(base / name, 'wb') as f:
      pickle.dump({b'data': rng.integers(0, 256, (2, 3072), np.uint8),
                   b'labels': list(rng.integers(0, 10, 2))}, f)
  got = datasets.load_cifar10_batches(str(tmp_path))
  want = jax_data._load_cifar10_batches(str(tmp_path))
  for g, w in zip(got, want):
    assert len(g) == len(w) == (10 if g is got[0] else 2)
    for i in range(len(w)):
      (g_image, g_label), (w_image, w_label) = g[i], w[i]
      assert g_image.dtype == w_image.dtype == np.float32
      assert np.array_equal(g_image, w_image) and g_label == w_label
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path))
  _, torch_config = port_parity.tiny_configs()
  torch_config.training.batch_size = 2
  torch_config.data.image_size = 32
  train, _ = datasets.get_dataset(torch_config)
  assert isinstance(train.dataset, datasets.ArrayImages)
  assert datasets.load_cifar10_batches(os.fspath(tmp_path / 'none')) is None
