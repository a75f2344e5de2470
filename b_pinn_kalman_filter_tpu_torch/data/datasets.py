"""Datasets and loaders giving NHWC numpy batches: the CIFAR-10 path.

The port's own copy of the parts of the JAX package's ``data/datasets.py``
that training the flagship reads: ``get_dataset`` (its CIFAR10 branch),
``NumpyLoader`` (epoch reshuffles, full batches), the native reader of the
``cifar-10-batches-py`` pickles, and the synthetic stand-in,
``SyntheticImages`` over ``smooth_field``, which ``get_dataset`` returns
when no CIFAR-10 files are present (the same seed gives the same bits as
the JAX package).  Left out: the ``PrefetchLoader`` thread that overlaps
batch assembly with the device step there (the port's train loop fetches
each batch in turn), the thread pool of ``NumpyLoader(num_workers>1)``
(which gives the same batches), and the other datasets.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional, Tuple

import numpy as np


def data_dir() -> str:
  """Local data root: ``$BPKF_DATA_DIR``, else ``./data``."""
  return os.environ.get('BPKF_DATA_DIR', './data')


def smooth_field(rng: np.random.Generator, shape: Tuple[int, ...],
                 smoothness: int = 8) -> np.ndarray:
  """Smooth random field in [0, 1]: low-resolution noise, bilinearly
  upsampled, then scaled to [0, 1]."""
  h, w = shape[-2], shape[-1]
  lo = rng.standard_normal(shape[:-2] + (max(2, h // smoothness),
                                         max(2, w // smoothness)))
  ys = np.linspace(0, lo.shape[-2] - 1, h)
  xs = np.linspace(0, lo.shape[-1] - 1, w)
  y0 = np.floor(ys).astype(int)
  y1 = np.minimum(y0 + 1, lo.shape[-2] - 1)
  x0 = np.floor(xs).astype(int)
  x1 = np.minimum(x0 + 1, lo.shape[-1] - 1)
  wy = (ys - y0)[:, None]
  wx = (xs - x0)[None, :]
  a = lo[..., y0, :][..., :, x0]
  b = lo[..., y0, :][..., :, x1]
  c = lo[..., y1, :][..., :, x0]
  d = lo[..., y1, :][..., :, x1]
  out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx)
         + d * wy * wx)
  out = out - out.min(axis=(-2, -1), keepdims=True)
  denom = out.max(axis=(-2, -1), keepdims=True)
  return out / np.maximum(denom, 1e-8)


class SyntheticImages:
  """Deterministic synthetic image dataset (the CIFAR-like stand-in): item
  ``i`` is a smooth field from the seed ``seed * 1_000_003 + i``, HWC
  float32 in [0, 1], with label 0."""

  def __init__(self, n: int, size: int, channels: int, seed: int = 0):
    self.n, self.size, self.channels, self.seed = n, size, channels, seed

  def __len__(self):
    return self.n

  def __getitem__(self, idx):
    rng = np.random.default_rng(self.seed * 1_000_003 + idx)
    img = smooth_field(rng, (self.channels, self.size, self.size), 4)
    return img.transpose(1, 2, 0).astype(np.float32), 0


class ArrayImages:
  """Indexable dataset over an in-memory (N, H, W, C) [0, 1] image array."""

  def __init__(self, images: np.ndarray, labels: Optional[np.ndarray] = None):
    self.images = images
    self.labels = labels

  def __len__(self):
    return len(self.images)

  def __getitem__(self, i):
    label = int(self.labels[i]) if self.labels is not None else 0
    return self.images[i], label


class NumpyLoader:
  """Endless shuffled batch iterator over an indexable dataset.

  Each epoch's order is a permutation from one ``numpy`` generator seeded
  with ``seed`` (the identity order without ``shuffle``); the last partial
  batch of an epoch is dropped.  Over fewer items than a batch,
  consecutive reshuffled epochs are concatenated so that every batch is
  full, as the JAX package's infinite loader does.  (Its finite
  ``num_epochs`` mode serves the ``evaluate`` mode, not ported yet.)
  """

  def __init__(self, dataset, batch_size: int, shuffle: bool = True,
               seed: int = 0):
    self.dataset = dataset
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.seed = seed

  def _epoch_order(self, rng, n):
    return rng.permutation(n) if self.shuffle else np.arange(n)

  def __iter__(self) -> Iterator:
    rng = np.random.default_rng(self.seed)
    n = len(self.dataset)
    if n == 0:
      raise ValueError('NumpyLoader: empty dataset (would never yield)')

    def fetch(idx):   # (images, labels), each stacked over the batch
      return tuple(np.stack(column)
                   for column in zip(*(self.dataset[i] for i in idx)))

    if n < self.batch_size:
      buf: list = []
      while True:
        while len(buf) < self.batch_size:
          buf.extend(int(i) for i in self._epoch_order(rng, n))
        idx, buf = buf[:self.batch_size], buf[self.batch_size:]
        yield fetch(idx)
    while True:
      order = self._epoch_order(rng, n)
      for start in range(0, n - self.batch_size + 1, self.batch_size):
        yield fetch([int(i) for i in order[start:start + self.batch_size]])


def load_cifar10_batches(root: str):
  """(train, test) ``ArrayImages`` from the standard
  ``root/cifar-10-batches-py`` pickles, or None where they are missing."""
  base = os.path.join(root, 'cifar-10-batches-py')
  if not os.path.isdir(base):
    return None

  def read(names):
    data, labels = [], []
    for n in names:
      path = os.path.join(base, n)
      if not os.path.exists(path):
        continue
      with open(path, 'rb') as f:
        d = pickle.load(f, encoding='bytes')
      imgs = np.asarray(d[b'data'], np.uint8)
      batch_labels = d.get(b'labels', d.get(b'fine_labels'))
      if batch_labels is None:
        raise ValueError(f'CIFAR-10 batch {n!r} has no labels key')
      if len(batch_labels) != len(imgs):
        raise ValueError(f'CIFAR-10 batch {n!r}: {len(imgs)} images vs '
                         f'{len(batch_labels)} labels')
      data.append(imgs)
      labels.extend(batch_labels)
    if not data:
      return None
    data = np.concatenate(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return data.astype(np.float32) / 255.0, np.asarray(labels, np.int64)

  train = read([f'data_batch_{i}' for i in range(1, 6)])
  test = read(['test_batch'])
  if train is None or test is None:
    return None
  return ArrayImages(*train), ArrayImages(*test)


def get_dataset(config):
  """(train loader, eval loader) of NHWC float32 [0, 1] batches of
  ``training.batch_size``, as the JAX package's ``get_dataset`` gives the
  train loop.

  CIFAR10 only: the local ``cifar-10-batches-py`` files under
  :func:`data_dir` where present, else ``SyntheticImages`` (4096 train and
  512 test items, seeds ``config.seed`` and ``config.seed + 1``).  As in
  the JAX package, ``data.uniform_dequantization`` and ``data.random_flip``
  are not applied on this branch.
  """
  if config.data.dataset != 'CIFAR10':
    raise NotImplementedError(
        f'dataset {config.data.dataset} is not ported yet: ROADMAP.md A.14')
  batch_size = config.training.batch_size
  size, channels = config.data.image_size, config.data.num_channels
  datasets = load_cifar10_batches(data_dir())
  if datasets is None:
    datasets = (SyntheticImages(4096, size, channels, config.seed),
                SyntheticImages(512, size, channels, config.seed + 1))
  train_ds, test_ds = datasets
  train_loader = NumpyLoader(train_ds, batch_size, shuffle=True,
                             seed=config.seed)
  test_loader = NumpyLoader(test_ds, batch_size, shuffle=False,
                            seed=config.seed + 1)
  return train_loader, test_loader
