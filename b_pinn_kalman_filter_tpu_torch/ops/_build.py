"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for ``sm_90a`` into a shared library and loaded with ``ctypes``; every
pointer and the stream are passed as ``c_void_p``.  Libraries go into
``b_pinn_kalman_filter_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  :func:`build_all` starts
one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, List

import torch
import torch.autograd.forward_ad as fwAD

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
SOURCES = ('conv3x3', 'conv3x3_wgmma', 'groupnorm', 'groupnorm_pergroup',
           'correlation', 'correlation_bwd', 'correlation_tile', 'ns_step',
           'ns_step_staged')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
    if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
      return os.path.join(root, 'bin', 'nvcc')
  raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit')


def library_path(name: str) -> str:
  with open(os.path.join(CSRC, f'{name}.cu'), 'rb') as f:
    digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
  return os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:16]}.so')


def _start(name: str):
  """Start ``nvcc`` on one source; returns (process, temporary output)."""
  os.makedirs(BUILD_DIR, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
  os.close(fd)
  cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, f'{name}.cu')]
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  return proc, tmp


def _finish(name: str, proc, tmp: str, out: str) -> str:
  log = proc.communicate()[0]
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f'nvcc failed on csrc/{name}.cu:\n{log}')
  os.replace(tmp, out)   # atomic: a reader never sees half a library
  return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
  """Compile every source that has no library yet, all in parallel.

  Returns ``{name: nvcc output}`` for the sources compiled by this call
  (the ``-Xptxas -v`` lines give each kernel's registers and spills).
  """
  started: List = []
  try:
    for name in names:
      out = library_path(name)
      if not os.path.exists(out):
        started.append((name, out) + _start(name))
    return {name: _finish(name, proc, tmp, out)
            for name, out, proc, tmp in started}
  finally:
    for _, _, proc, tmp in started:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
      if os.path.exists(tmp):
        os.unlink(tmp)


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, built first if needed.

  ``signatures`` maps each C function to its ``argtypes``; every function
  returns an ``int`` (the CUDA error code of its launch).
  """
  lib = _LOADED.get(name)
  if lib is None:
    build_all([name])
    lib = ctypes.CDLL(library_path(name))
    for fn_name, argtypes in signatures.items():
      fn = getattr(lib, fn_name)
      fn.argtypes = list(argtypes)
      fn.restype = ctypes.c_int
    _LOADED[name] = lib
  return lib


def aligned(t: torch.Tensor) -> torch.Tensor:
  """``t`` contiguous and starting on a 16-byte boundary (a view may start
  elsewhere), as the kernels' 16-byte loads need."""
  t = t.contiguous()
  return t if t.data_ptr() % 16 == 0 else t.clone()


def check_launch(err: int, what: str) -> None:
  """Raise if a launch returned a CUDA error code."""
  if err != 0:
    raise RuntimeError(f'{what}: CUDA launch failed with error {err}')


def forward_only(what: str, *tensors) -> None:
  """Raise where autograd would need a backward that is not written yet."""
  if torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in tensors):
    raise RuntimeError(
        f'{what} is forward-only: its backward comes with the training '
        'slice.  Call it under torch.no_grad() or torch.inference_mode().')


def tangents(what: str, *tensors) -> bool:
  """Whether any of ``tensors`` carries a forward-mode tangent
  (``torch.autograd.forward_ad`` or ``torch.func.jvp``).

  Raises ``NotImplementedError`` for such a tensor off the CPU: the kernels
  have no forward-mode rule yet (ROADMAP.md B.3), and a launch would drop
  the tangent without a word.  On the CPU the plain versions carry it.
  """
  dual = [t for t in tensors
          if t is not None and fwAD.unpack_dual(t).tangent is not None]
  if any(t.device.type != 'cpu' for t in dual):
    raise NotImplementedError(
        f'{what}: forward-mode tangents through the kernel are not '
        'supported yet (ROADMAP.md B.3); use reverse mode')
  return bool(dual)
