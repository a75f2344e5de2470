"""The port's data paths against the JAX package's ``data/datasets.py``:
the synthetic stand-in, the loader's epoch reshuffles and full batches,
the native CIFAR-10 reader and ``get_dataset``; the PDE dataset, the
inpainting masks and the MNIST reader, bit for bit from the same seeds."""

import gzip
import itertools
import os
import pickle
import struct

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


def _rollout(seed=0, frames=30, h=12, w=20):
  """A small (T, 6, H, W) float32 array standing in for a rollout."""
  rng = np.random.default_rng(seed)
  return rng.standard_normal((frames, 6, h, w)).astype(np.float32)


@pytest.mark.parametrize('split,size', [('train', 8), ('test', 8),
                                        ('train', 16)])
def test_pde_items_equal_jax(split, size):
  """Every item of both splits, including crops that pad (``size`` 16 >
  the 12 rows) and the odd ``trim``."""
  data = _rollout()
  port = datasets.PDEDataset(data, size, split, trim=7, seed=3)
  ref = jax_data.PDEDataset(data, size, split, trim=7, seed=3)
  assert len(port) == len(ref) == (19 if split == 'train' else 2)
  for i in range(len(ref)):
    got, want = port[i], ref[i]
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
      assert np.asarray(a).dtype == np.asarray(b).dtype == np.float32
      assert np.array_equal(a, b)
  assert got[0].shape == (size, size, 1) and got[5].shape == (size, size, 3)


@pytest.mark.parametrize('invert', [False, True])
def test_masks_equal_jax(invert):
  """``inpaint_rnd``: the same uniform masks from the same seed."""
  jax_config, torch_config = port_parity.tiny_pinn_configs()
  for config in (jax_config, torch_config):
    config.inverse.invert = invert
  port = datasets.get_mask_dataset(torch_config)
  ref = jax_data.get_mask_dataset(jax_config)
  for _ in range(5):
    got, want = port.next(), ref.next()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (16, 16, 1) and np.array_equal(got, want)


def _write_idx(path, images, compress=False):
  opener = gzip.open if compress else open
  with opener(path, 'wb') as f:
    f.write(struct.pack('>IIII', 2051, *images.shape))
    f.write(images.tobytes())


def test_mnist_reader_and_digit_masks_equal_jax(tmp_path, monkeypatch):
  """A tiny idx file, plain and gzipped under ``MNIST/raw``: the same
  images, and the ``inpaint`` masks made from them."""
  rng = np.random.default_rng(2)
  images = rng.integers(0, 256, (4, 28, 28), np.uint8)
  _write_idx(tmp_path / 'train-images-idx3-ubyte', images)
  raw = tmp_path / 'gz' / 'MNIST' / 'raw'
  raw.mkdir(parents=True)
  _write_idx(raw / 'train-images-idx3-ubyte.gz', images, compress=True)
  for root in (tmp_path, tmp_path / 'gz'):
    got = datasets.load_mnist_idx(str(root))
    assert np.array_equal(got, jax_data.load_mnist_idx(str(root)))
    assert np.array_equal(got, images)
  assert datasets.load_mnist_idx(str(tmp_path / 'none')) is None
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path))
  jax_config, torch_config = port_parity.tiny_pinn_configs()
  for config in (jax_config, torch_config):
    config.inverse.operator = 'inpaint'
  port = datasets.get_mask_dataset(torch_config)
  ref = jax_data.get_mask_dataset(jax_config)
  for _ in range(3):
    assert np.array_equal(port.next(), ref.next())


def test_pde_branch_of_get_dataset(tmp_path, monkeypatch):
  """``pinn/pinn_pde`` at image size 16: the synthetic rollout of 400
  frames at 200 x 32, stepped on the CPU and kept under the port's own
  file name; 59 train and 39 test items; full batches of the six
  fields."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path))
  _, config = port_parity.tiny_pinn_configs()
  config.training.batch_size = 4
  train, test = datasets.get_dataset(config, device='cpu')
  assert os.listdir(tmp_path) == ['ns_rollout_port_400x200x32_42.npy']
  assert (len(train.dataset), len(test.dataset)) == (59, 39)
  assert train.dataset.data.shape == (400, 6, 200, 32)
  for loader in (train, test):
    f1, f2, x, y, t, target = _batches(loader, 1)[0]
    for a in (f1, f2, x, y):
      assert a.shape == (4, 16, 16, 1) and a.dtype == np.float32
    assert target.shape == (4, 16, 16, 3) and t.shape == (4,)
    assert np.isfinite(target).all()
  # The second call reads the file.
  again, _ = datasets.get_dataset(config, device='cpu')
  assert np.array_equal(again.dataset.data, train.dataset.data)
