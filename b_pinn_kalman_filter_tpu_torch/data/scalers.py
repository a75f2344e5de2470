"""Data scalers (copy of the JAX package's ``data/datasets.py`` scalers)."""

from typing import Callable


def get_data_scaler(config) -> Callable:
  """Data normalizer; data assumed in [0, 1]."""
  if config.data.centered:
    return lambda x: x * 2. - 1.
  return lambda x: x


def get_data_inverse_scaler(config) -> Callable:
  """Inverse data normalizer."""
  if config.data.centered:
    return lambda x: (x + 1.) / 2.
  return lambda x: x
