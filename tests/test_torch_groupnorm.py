"""Kernel K2 (GroupNorm+act): the port's plain version against the JAX
package's Pallas kernel (interpret mode).  The CUDA kernel against the plain
version: tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.ops.groupnorm_pallas import groupnorm_act
from b_pinn_kalman_filter_tpu_torch.device import get_device
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from tests.port_parity import one_torch_thread  # noqa: F401


# The tolerance tests/test_groupnorm_pallas.py holds the kernel to in f32.
TOL = 2e-5


def _inputs(shape, seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal(shape).astype(np.float32)
  scale = rng.standard_normal(shape[-1]).astype(np.float32)
  bias = rng.standard_normal(shape[-1]).astype(np.float32)
  return x, scale, bias


@pytest.mark.parametrize('act', ['silu', 'none'])
def test_plain_matches_pallas_interpret(act):
  x, scale, bias = _inputs((2, 8, 8, 128))
  want = groupnorm_act(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                       num_groups=32, act=act, interpret=True)
  with torch.inference_mode():
    got = k2.groupnorm_act(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), num_groups=32, act=act)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                             atol=TOL)


def test_default_device_raises_without_cuda():
  if torch.cuda.is_available():
    assert get_device().type == 'cuda'
  else:
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      get_device()


def test_no_fallback_off_cpu():
  x = torch.empty((1, 4, 4, 32), device='meta')
  s = torch.empty((32,), device='meta')
  with pytest.raises(ValueError, match='no kernel for device'):
    k2.groupnorm_act(x, s, s)


def test_forward_only_raises_under_grad():
  x, scale, bias = _inputs((1, 4, 4, 32))
  with pytest.raises(RuntimeError, match='training slice'):
    k2.groupnorm_act(torch.from_numpy(x).requires_grad_(),
                     torch.from_numpy(scale), torch.from_numpy(bias))
