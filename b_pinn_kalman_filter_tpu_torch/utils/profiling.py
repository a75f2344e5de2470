"""Tracing, timing and NaN checks.

Counterpart of the JAX package's ``utils/profiling.py``: a
``torch.profiler`` trace where JAX takes ``jax.profiler``'s, a timer that
synchronises the card where JAX blocks on a device value, anomaly
detection where JAX sets ``jax_debug_nans``, and a finite check over a
``{name: tensor}`` tree.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Mapping, Optional

import torch

logger = logging.getLogger(__name__)


def enable_nan_debugging(enable: bool = True) -> None:
  """Raise where a backward produces a NaN (``torch.autograd``'s anomaly
  detection, with its forward traces), as ``jax_debug_nans`` raises."""
  torch.autograd.set_detect_anomaly(enable, check_nan=True)


def check_for_nans(params: Any, name: str = 'params') -> bool:
  """True, with a warning for each, where a tensor of ``params`` (a tensor,
  or a dict of them, nested) has a NaN or an infinity."""
  bad = False
  if isinstance(params, Mapping):
    for key, value in params.items():
      bad |= check_for_nans(value, f'{name}.{key}')
  elif isinstance(params, torch.Tensor):
    if not bool(torch.isfinite(params).all()):
      logger.warning('NaN/inf detected in %s', name)
      bad = True
  return bad


@contextlib.contextmanager
def trace(logdir: str):
  """A ``torch.profiler`` trace of the block (host and, where there is a
  card, device activity) written to ``logdir`` for TensorBoard."""
  from torch.profiler import (ProfilerActivity, profile,
                              tensorboard_trace_handler)
  activities = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
  with profile(activities=activities,
               on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
    yield prof


@contextlib.contextmanager
def timed(label: str, result_holder: Optional[dict] = None):
  """Host seconds of the block, the card's queued work included (it is
  synchronised at the end); logged, and kept under ``label`` in
  ``result_holder``."""
  start = time.perf_counter()
  yield
  if torch.cuda.is_available():
    torch.cuda.synchronize()
  seconds = time.perf_counter() - start
  logger.info('%s: %.4fs', label, seconds)
  if result_holder is not None:
    result_holder[label] = seconds
