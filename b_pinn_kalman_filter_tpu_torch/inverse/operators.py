"""Linear observation operators for inverse problems.

Counterpart of the JAX package's ``inverse/operators.py``.  The inpainting
operator A = diag(mask) stays in its diagonal form: ``A x = mask * x``, the
ill-posed observation is the zero-padded flat vector (B, C, H*W) (its zero
rows are the rows the reference's compacted vector leaves out), and the
projections the samplers need are mask algebra.  ``to_matrix`` gives the
explicit matrices for small problems.  NHWC images.
"""

from __future__ import annotations

import abc
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def get_operator(config, device=None):
  """``'inpaint'`` and ``'inpaint_rnd'``: an :class:`InpaintOperator` over
  the config's mask stream (``data/datasets.py`` ``get_mask_dataset``),
  its masks on ``device``; ``'blur'``: a :class:`GaussianFilter` of
  ``inverse.blur_kernel`` (default 9) and ``inverse.blur_std`` (2.0)."""
  if config.inverse.operator in ('inpaint', 'inpaint_rnd'):
    from b_pinn_kalman_filter_tpu_torch.data.datasets import get_mask_dataset
    return InpaintOperator(mask_source=get_mask_dataset(config),
                           device=device)
  if config.inverse.operator == 'blur':
    k = int(config.inverse.get('blur_kernel', 9))
    std = float(config.inverse.get('blur_std', 2.0))
    return GaussianFilter((k, k), std)
  raise NotImplementedError


class LinearOperator(abc.ABC):
  """A linear observation operator A."""

  @abc.abstractmethod
  def next(self):
    """Advance to the next operator instance (e.g. a new random mask)."""

  @abc.abstractmethod
  def __call__(self, x: Tensor, keep_shape: bool = False,
               invert: bool = False) -> Tensor:
    """A x: image-shaped with ``keep_shape``, else the flat observation
    (B, C, N)."""

  @abc.abstractmethod
  def to_matrix(self, shape) -> np.ndarray:
    """Explicit matrix form of A (small problems, tests)."""

  def observation_mask(self, y: Tensor) -> Tensor:
    """Indicator of the live rows of a flat observation: all ones for a
    surjective operator."""
    return torch.ones_like(y)


class ScalerMult(LinearOperator):
  """A = k I."""

  def __init__(self, k: float):
    self.k = float(k)

  def next(self):
    pass

  def __call__(self, x, keep_shape=False, invert=False):
    return self.k * x

  def to_matrix(self, shape):
    return self.k * np.eye(int(np.prod(shape)))


class MatrixMult(LinearOperator):
  """An explicit (M, N) matrix applied to each channel's flat M-vector."""

  def __init__(self, matrix):
    self.matrix = torch.as_tensor(np.asarray(matrix))

  def next(self):
    pass

  def __call__(self, x, keep_shape=False, invert=False):
    m = self.matrix.to(device=x.device, dtype=x.dtype)
    return torch.einsum('bcm,mn->bcn', x.reshape(x.shape[0], -1, m.shape[0]),
                        m)

  def to_matrix(self, shape):
    return self.matrix.numpy()


def _symmetric_index(n: int, before: int, after: int) -> np.ndarray:
  """Indices of ``np.pad(mode='symmetric')`` along an axis of length n."""
  idx = np.arange(-before, n + after)
  idx = np.where(idx < 0, -idx - 1, idx)
  return np.where(idx >= n, 2 * n - idx - 1, idx)


class GaussianFilter(LinearOperator):
  """Gaussian blur: the 'same' convolution with symmetric boundaries of
  scipy's ``convolve2d(boundary='symm')``."""

  def __init__(self, shape: Tuple[int, int], std: float):
    self.kshape = shape
    self.std = float(std)

  def next(self):
    pass

  def get_kernel(self) -> np.ndarray:
    w, h = self.kshape
    gx, gy = np.meshgrid(np.arange(0, w) - w // 2, np.arange(0, h) - h // 2)
    kernel = np.exp(-(gx ** 2 + gy ** 2) / (2 * self.std))
    return (kernel / kernel.sum()).astype(np.float32)

  def __call__(self, x, keep_shape=True, invert=False):
    kernel = torch.from_numpy(self.get_kernel()).to(x.device)
    kh, kw = kernel.shape
    x2 = x[None, :, :, None] if x.ndim == 2 else x
    _, H, W, C = x2.shape
    rows = torch.from_numpy(_symmetric_index(H, (kh - 1) // 2, kh // 2))
    cols = torch.from_numpy(_symmetric_index(W, (kw - 1) // 2, kw // 2))
    x2 = x2[:, rows.to(x.device)][:, :, cols.to(x.device)]
    # Cross-correlation with the flipped kernel: a convolution.
    w = kernel.flip(0, 1).to(x.dtype).expand(C, 1, kh, kw)
    out = F.conv2d(x2.permute(0, 3, 1, 2), w, groups=C).permute(0, 2, 3, 1)
    return out[0, :, :, 0] if x.ndim == 2 else out

  def to_matrix(self, shape) -> np.ndarray:
    """Explicit 'valid' convolution matrix."""
    kernel = self.get_kernel()
    W, H = shape
    kW, kH = kernel.shape
    mW, mH = W - kW + 1, H - kH + 1
    mat = np.zeros((mW * mH, W * H), np.float32)
    for i in range(mW * mH):
      offset = (i // mH) * H + i % mH
      for r in range(kW):
        mat[i, r * H + offset: r * H + offset + kH] = kernel[r]
    return mat


def _tensor(mask, device) -> Tensor:
  """A mask (tensor or array) as a tensor on ``device`` (or its own)."""
  if not isinstance(mask, Tensor):
    mask = torch.from_numpy(np.asarray(mask))
  return mask.to(device) if device is not None else mask


class InpaintOperator(LinearOperator):
  """The masking operator A = diag(mask); ``mask_source.next()`` gives
  (H, W, 1) float masks, or ``mask`` (an array or a tensor) one fixed
  mask; on ``device`` where given."""

  def __init__(self, mask_source=None, mask=None, device=None):
    self.mask_source = mask_source
    self.device = device
    if mask is not None:
      self.mask = _tensor(mask, device)
    else:
      self.next()

  def next(self):
    if self.mask_source is not None:
      self.mask = _tensor(self.mask_source.next(), self.device)

  def _m(self, invert):
    return (1.0 - self.mask) if invert else self.mask

  def __call__(self, x, keep_shape=True, invert=False):
    masked = self._m(invert) * x
    if keep_shape:
      return masked
    # The flat observation (B, C, H*W): A x with its zero rows kept.
    return masked.reshape(x.shape[0], -1, x.shape[-1]).permute(0, 2, 1)

  def observation_mask(self, y: Tensor) -> Tensor:
    flat = self.mask.reshape(1, -1, self.mask.shape[-1]).permute(0, 2, 1)
    return flat.expand(y.shape)

  def project_observed(self, y_flat: Tensor, image_shape) -> Tensor:
    """L^T A y: a flat observation scattered back to image space (the
    masked image, A being diagonal)."""
    B, C = y_flat.shape[:2]
    H, W = image_shape
    return self.mask * y_flat.permute(0, 2, 1).reshape(B, H, W, C)

  def to_matrix(self, shape) -> np.ndarray:
    return np.diag(self.mask.cpu().numpy().flatten())

  def decompose(self, shape):
    """A = pL @ T with pL the kept rows' projection (explicit matrices,
    for tests)."""
    A = self.to_matrix(shape)
    keep = np.where(A.sum(axis=1) == 1)[0]
    return A, A[keep].T, 1


def bcmm(m: Tensor, v: Tensor) -> Tensor:
  """Batched channelled matrix product: m (B, C, M, N), v (B, C, M) ->
  (B, C, N)."""
  B, C, M, N = m.shape
  return torch.einsum('bim,bmn->bin', v.reshape(-1, 1, M),
                      m.reshape(-1, M, N)).reshape(B, C, N)


def observe(x: Tensor, operator: LinearOperator,
            generator: Optional[torch.Generator] = None, sigma: float = 1.0,
            noise: Optional[Tensor] = None) -> Tensor:
  """A noisy observation y = A x + sigma n, n standard normal from
  ``generator`` (or ``noise`` where given)."""
  y = operator(x)
  if noise is None:
    noise = torch.randn(y.shape, generator=generator, device=y.device)
  return y + noise * sigma
