"""Datasets and loaders giving NHWC numpy batches: the CIFAR-10 and PDE
paths, and the inpainting masks.

The port's own copy of the parts of the JAX package's ``data/datasets.py``
that training the flagship and the PINN and the inverse suite read:
``get_dataset`` (its CIFAR10, PDE and NC branches, the synthetic
stand-ins of its SVHN, CELEBA, LSUN, FFHQ and CelebAHQ branches, and the
one-epoch eval loader of ``evaluation=True``), ``NumpyLoader`` (epoch reshuffles,
full batches, endless or ``num_epochs``), the native reader of the
``cifar-10-batches-py`` pickles, and the synthetic stand-in,
``SyntheticImages`` over ``smooth_field``, which ``get_dataset`` returns
when no CIFAR-10 files are present (the same seed gives the same bits as
the JAX package); ``PDEDataset`` over a synthetic Navier-Stokes
rollout; ``NCDataset`` over the ocean-temperature file, read by
:func:`load_netcdf`, or its synthetic stand-in; ``MaskIterator`` with the
MNIST idx reader.  Left out: the
``PrefetchLoader`` thread that overlaps batch assembly with the device
step there (the port's train loops fetch each batch in turn), the thread
pool of ``NumpyLoader(num_workers>1)`` (which gives the same batches), the
NetCDF reader of the PDE branch (the synthetic rollout stands in for the
simulation file).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tempfile
import zlib
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
  """Shuffled batch iterator over an indexable dataset: endless, or
  ``num_epochs`` epochs.

  Each epoch's order is a permutation from one ``numpy`` generator seeded
  with ``seed`` (the identity order without ``shuffle``); the last partial
  batch of an epoch is dropped, so an epoch over fewer items than a batch
  yields none (``torch`` ``drop_last``, as the JAX package's finite
  loader).  An endless loader over fewer items than a batch concatenates
  consecutive reshuffled epochs so that every batch is full, as the JAX
  package's does.
  """

  def __init__(self, dataset, batch_size: int, shuffle: bool = True,
               seed: int = 0, num_epochs: Optional[int] = None):
    self.dataset = dataset
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.seed = seed
    self.num_epochs = num_epochs

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

    if self.num_epochs is None and n < self.batch_size:
      buf: list = []
      while True:
        while len(buf) < self.batch_size:
          buf.extend(int(i) for i in self._epoch_order(rng, n))
        idx, buf = buf[:self.batch_size], buf[self.batch_size:]
        yield fetch(idx)
    epoch = 0
    while self.num_epochs is None or epoch < self.num_epochs:
      order = self._epoch_order(rng, n)
      for start in range(0, n - self.batch_size + 1, self.batch_size):
        yield fetch([int(i) for i in order[start:start + self.batch_size]])
      epoch += 1


def random_crop(rng: np.random.Generator, img: np.ndarray,
                size: int) -> np.ndarray:
  """Random spatial crop (zero-padded up to ``size`` first) of an
  (..., H, W) array: the row, then the column, from ``rng``."""
  h, w = img.shape[-2], img.shape[-1]
  if h < size or w < size:
    pads = [(0, 0)] * (img.ndim - 2) + [(0, max(0, size - h)),
                                        (0, max(0, size - w))]
    img = np.pad(img, pads)
    h, w = img.shape[-2], img.shape[-1]
  i = int(rng.integers(0, h - size + 1))
  j = int(rng.integers(0, w - size + 1))
  return img[..., i:i + size, j:j + size]


class NCDataset:
  """Ocean-temperature frames ``data`` (T, D, H, W): item ``idx`` is the
  depth-0 frame below ``land_cut`` rows, randomly cropped to
  ``image_size`` from the seed ``seed * 1_000_003 + idx``, HWC float32,
  with label 0.  The train split is the first 80% of the frames, the test
  split the last 20%."""

  def __init__(self, data: np.ndarray, image_size: int, split: str = 'train',
               land_cut: int = 0, seed: int = 0):
    self.data = data
    self.len = len(data)
    self.split = split
    self.land_cut = land_cut
    self.image_size = image_size
    self.seed = seed

  def __len__(self):
    return (int(self.len * 0.8) if self.split == 'train'
            else int(self.len * 0.2))

  def __getitem__(self, idx):
    base = idx if self.split == 'train' else int(self.len * 0.8) + idx
    rng = np.random.default_rng(self.seed * 1_000_003 + idx)
    sample = self.data[base, 0, self.land_cut:]
    sample = random_crop(rng, sample[None], self.image_size)[0]
    return sample[..., None].astype(np.float32), 0


def load_netcdf(path: str, key: str) -> Optional[np.ndarray]:
  """Variable ``key`` of the netCDF file at ``path``, or None: read with
  netCDF4 where it is installed, else ``scipy.io.netcdf_file`` (classic
  NetCDF-3), else from a sibling ``<path>.npz`` holding the same
  variable name; the JAX package's reader order."""
  if os.path.exists(path):
    try:
      from netCDF4 import Dataset as NetCDF
      return np.asarray(NetCDF(path)[key])
    except Exception:
      pass
    try:
      from scipy.io import netcdf_file
      with netcdf_file(path, 'r', mmap=False) as ds:
        return np.asarray(ds.variables[key][:], np.float32)
    except Exception:
      pass
  npz = path + '.npz'
  if os.path.exists(npz):
    try:
      return np.asarray(np.load(npz)[key], np.float32)
    except Exception:
      return None
  return None


def nc_data(config) -> np.ndarray:
  """The NC branch's frames (T, D, H, W): ``data.key`` of
  ``bsose_i122_{data.date_range}_{data.category}.nc`` at the simulation
  archive's path, else under :func:`data_dir`, else the synthetic
  stand-in, ``smooth_field`` of shape (512, 1, 256 + ``data.land_cut``,
  256) from ``config.seed``, as the JAX package makes it."""
  path = (f'/data1/DATA_PUBLIC/Southern_Ocean/'
          f'bsose_i122_{config.data.date_range}_{config.data.category}.nc')
  data = load_netcdf(path, config.data.key)
  if data is None:
    data = load_netcdf(os.path.join(data_dir(), os.path.basename(path)),
                       config.data.key)
  if data is None:
    rng = np.random.default_rng(config.seed)
    data = smooth_field(rng, (512, 1, 256 + config.data.land_cut, 256), 8)
    data = data.astype(np.float32)
  return data


class PDEDataset:
  """Consecutive frames of a Navier-Stokes rollout ``data`` (T, 6, H, W)
  whose channels are coordx, coordy, density, u, v, p.

  Item ``idx`` is ``(f1, f2, x, y, t, target)``: the densities of frames
  ``base`` and ``base + 1``, the coordinates of the second, ``t = idx +
  1``, and the target (u, v, p) of the second, each HWC float32, all
  cropped alike to ``image_size`` from the seed ``seed * 1_000_003 +
  idx``.  The train split starts at frame ``trim`` and ends at 90% of
  the rollout, the test split takes the last 10%.
  """

  def __init__(self, data: np.ndarray, image_size: int, split: str = 'train',
               trim: int = 160, seed: int = 0):
    self.data = data
    self.len = len(data)
    self.split = split
    self.offset = trim
    self.image_size = image_size
    self.seed = seed

  def __len__(self):
    n = (int(self.len * 0.9) - self.offset if self.split == 'train'
         else int(self.len * 0.1))
    return max(n - 1, 0)

  def __getitem__(self, idx):
    base = (idx + self.offset if self.split == 'train'
            else int(self.len * 0.9) + idx)
    rng = np.random.default_rng(self.seed * 1_000_003 + idx)
    sample = random_crop(rng, self.data[base:base + 2], self.image_size)
    x_p, x_t = sample[0], sample[1]

    def hwc(a):
      return np.ascontiguousarray(a.transpose(1, 2, 0)).astype(np.float32)

    return (hwc(x_p[2:3]), hwc(x_t[2:3]), hwc(x_t[0:1]), hwc(x_t[1:2]),
            np.float32(idx + 1), hwc(x_t[3:]))


def cached_ns_rollout(n_frames: int, h: int, w: int, seed: int,
                      device=None) -> np.ndarray:
  """The synthetic rollout (T, 6, H, W) of ``data/ns_rollout.py``, stepped
  on ``device`` (default ``cuda``), kept in ``data_dir()`` as
  ``ns_rollout_port_{T}x{H}x{W}_{seed}.npy`` and read from there when
  present (a name of the port's own: the JAX package keeps its rollout,
  stepped by another stepper, under another)."""
  from b_pinn_kalman_filter_tpu_torch.data.ns_rollout import ns_rollout
  base = data_dir()
  cache = os.path.join(base, f'ns_rollout_port_{n_frames}x{h}x{w}_{seed}.npy')
  if os.path.exists(cache):
    return np.load(cache)
  frames = ns_rollout(n_frames, h, w, seed, device=device).cpu().numpy()
  try:
    os.makedirs(base, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=base, suffix='.npy')
    with os.fdopen(fd, 'wb') as f:
      np.save(f, frames)
    os.replace(tmp, cache)   # a reader never sees half a file
  except OSError:
    pass
  return frames


def load_mnist_idx(root: str) -> Optional[np.ndarray]:
  """MNIST ``train-images-idx3-ubyte[.gz]`` under ``root`` or
  ``root/MNIST/raw``: (N, 28, 28) uint8, or None where it is missing."""
  for base in (root, os.path.join(root, 'MNIST', 'raw')):
    for name in ('train-images-idx3-ubyte', 'train-images-idx3-ubyte.gz'):
      path = os.path.join(base, name)
      if not os.path.exists(path):
        continue
      opener = gzip.open if name.endswith('.gz') else open
      with opener(path, 'rb') as f:
        magic, n, rows, cols = struct.unpack('>IIII', f.read(16))
        if magic != 2051:
          continue
        buf = f.read(n * rows * cols)
      return np.frombuffer(buf, np.uint8).reshape(n, rows, cols)
  return None


class MaskIterator:
  """Binary inpainting masks (H, W, 1) float32, one per ``next()``.

  With ``inverse.operator`` 'inpaint' and MNIST under :func:`data_dir`, a
  random digit, nearest-resized to ``data.image_size``; else a uniform
  random field.  The mask is where the image exceeds ``inverse.ratio``,
  or where it does not unless ``inverse.invert``.  One numpy generator
  seeded with ``config.seed + 12345`` draws them all.
  """

  def __init__(self, config):
    self.size = config.data.image_size
    self.ratio = config.inverse.ratio
    self.invert = config.inverse.invert
    self.rng = np.random.default_rng(config.seed + 12345)
    self._mnist = (load_mnist_idx(data_dir())
                   if config.inverse.operator == 'inpaint' else None)

  def next(self) -> np.ndarray:
    if self._mnist is not None:
      idx = int(self.rng.integers(0, len(self._mnist)))
      img = np.asarray(self._mnist[idx], np.float32) / 255.0
      ys = (np.arange(self.size) * img.shape[0] / self.size).astype(int)
      xs = (np.arange(self.size) * img.shape[1] / self.size).astype(int)
      img = img[np.ix_(ys, xs)]
    else:
      img = self.rng.random((self.size, self.size), np.float32)
    mask = img > self.ratio
    if not self.invert:
      mask = ~mask
    return mask.astype(np.float32)[..., None]


def get_mask_dataset(config) -> MaskIterator:
  return MaskIterator(config)


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


def synthetic_images(size: int, channels: int, seed: int):
  """(train, test) stand-ins of an image dataset: ``SyntheticImages`` of
  4096 and 512 items from ``seed`` and ``seed + 1``."""
  return (SyntheticImages(4096, size, channels, seed),
          SyntheticImages(512, size, channels, seed + 1))


def get_dataset(config, device=None, evaluation: bool = False):
  """(train loader, eval loader) of NHWC float32 batches, as the JAX
  package's ``get_dataset`` gives them: of ``training.batch_size`` and
  endless; with ``evaluation``, of ``eval.batch_size``, the eval loader
  one epoch (``evaluate`` reads it to its end).

  CIFAR10: [0, 1] images from the local ``cifar-10-batches-py`` files
  under :func:`data_dir` where present, else :func:`synthetic_images`
  from ``config.seed``; as in the JAX package, ``data.uniform_dequantization``
  and ``data.random_flip`` are not applied on this branch.

  SVHN, CELEBA, FFHQ, CelebAHQ: :func:`synthetic_images` from
  ``config.seed`` (no files are read, as the JAX package reads none for
  them); LSUN: the same from ``config.seed`` plus the CRC-32 of
  ``data.category`` modulo 997.

  PDE: ``PDEDataset`` tuples over the synthetic rollout of ``max(trim +
  64, 400)`` frames at 200 x ``2 * image_size`` (seed ``config.seed``,
  stepped on ``device``, default ``cuda``; :func:`cached_ns_rollout`),
  ``trim = data.time_trim``, the test split's crops from ``config.seed +
  1``.

  NC, NC_P: ``NCDataset`` over :func:`nc_data` (``data.land_cut``), the
  test split's crops from ``config.seed + 1``.
  """
  batch_size = (config.eval.batch_size if evaluation
                else config.training.batch_size)
  size, channels = config.data.image_size, config.data.num_channels
  name = config.data.dataset
  if name == 'CIFAR10':
    datasets = load_cifar10_batches(data_dir())
    if datasets is None:
      datasets = synthetic_images(size, channels, config.seed)
    train_ds, test_ds = datasets
  elif name in ('SVHN', 'CELEBA', 'FFHQ', 'CelebAHQ'):
    train_ds, test_ds = synthetic_images(size, channels, config.seed)
  elif name == 'LSUN':
    # The category folds into the seed, so that bedroom and church differ.
    category = str(config.data.get('category', 'bedroom'))
    seed = config.seed + zlib.crc32(category.encode()) % 997
    train_ds, test_ds = synthetic_images(size, channels, seed)
  elif name == 'PDE':
    trim = int(config.data.time_trim)
    data = cached_ns_rollout(max(trim + 64, 400), 200, 2 * size,
                             config.seed, device=device)
    train_ds = PDEDataset(data, size, 'train', trim, config.seed)
    test_ds = PDEDataset(data, size, 'test', trim, config.seed + 1)
  elif name in ('NC', 'NC_P'):
    data = nc_data(config)
    cut = config.data.land_cut
    train_ds = NCDataset(data, size, 'train', cut, config.seed)
    test_ds = NCDataset(data, size, 'test', cut, config.seed + 1)
  else:
    raise NotImplementedError(f'Dataset {name} not yet supported.')
  train_loader = NumpyLoader(train_ds, batch_size, shuffle=True,
                             seed=config.seed)
  test_loader = NumpyLoader(test_ds, batch_size, shuffle=False,
                            seed=config.seed + 1,
                            num_epochs=1 if evaluation else None)
  return train_loader, test_loader
