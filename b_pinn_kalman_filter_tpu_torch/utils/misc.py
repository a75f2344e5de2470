"""Image grids and a PNG writer.

Counterpart of the JAX package's ``utils/misc.py`` ``make_grid`` and
``save_image_grid``.  The PNG is written with the standard library
(``zlib``, ``struct``, ``binascii``) from numpy: 8-bit samples, one IDAT
chunk, every row with filter 0, so the port needs no image library.
"""

from __future__ import annotations

import binascii
import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# PNG colour type by channels: gray, RGB.
_COLOR_TYPES = {1: 0, 3: 2}


def make_grid(images: np.ndarray, nrow: int, padding: int = 2) -> np.ndarray:
  """Tile a batch of HWC images into one grid image, ``nrow`` a row, each
  framed by ``padding`` zeros (the torchvision layout)."""
  images = np.asarray(images)
  b, h, w, c = images.shape
  ncol = (b + nrow - 1) // nrow
  grid = np.zeros((ncol * (h + padding) + padding,
                   nrow * (w + padding) + padding, c), images.dtype)
  for i in range(b):
    r, col = divmod(i, nrow)
    y = r * (h + padding) + padding
    x = col * (w + padding) + padding
    grid[y:y + h, x:x + w] = images[i]
  return grid


def _chunk(tag: bytes, data: bytes) -> bytes:
  return (struct.pack('>I', len(data)) + tag + data
          + struct.pack('>I', binascii.crc32(tag + data) & 0xffffffff))


def write_png(path: str, image: np.ndarray) -> None:
  """Write a uint8 (H, W, C) image, C 1 (gray) or 3 (RGB), as an 8-bit
  PNG."""
  image = np.asarray(image)
  if image.dtype != np.uint8:
    raise ValueError(f'PNG samples must be uint8, not {image.dtype}')
  if image.ndim != 3 or image.shape[-1] not in _COLOR_TYPES:
    raise ValueError(f'cannot write an image of shape {image.shape}')
  h, w, c = image.shape
  rows = np.concatenate([np.zeros((h, 1), np.uint8),
                         np.ascontiguousarray(image).reshape(h, w * c)],
                        axis=1)
  header = struct.pack('>IIBBBBB', w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
  with open(path, 'wb') as fh:
    fh.write(PNG_SIGNATURE + _chunk(b'IHDR', header)
             + _chunk(b'IDAT', zlib.compress(rows.tobytes()))
             + _chunk(b'IEND', b''))


def save_image_grid(images: np.ndarray, path: str,
                    nrow: Optional[int] = None) -> None:
  """Save a batch of HWC float images in [0, 1] as one PNG grid (``nrow``
  default the square root of the batch).  The samples are ``grid * 255``
  clipped and truncated to uint8, as the JAX package converts them; a
  one-channel grid is saved as gray."""
  images = np.asarray(images)
  if nrow is None:
    nrow = int(np.sqrt(images.shape[0]))
  grid = make_grid(images, max(nrow, 1))
  grid = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
  write_png(path, grid)
