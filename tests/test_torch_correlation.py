"""Kernel K3 (FlowNet cost volume): the port's plain version against the JAX
package's XLA correlation and its Pallas kernel (interpret mode), on the
CPU.  The CUDA kernel against the plain version:
tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.ops.correlation import correlation as jax_corr
from b_pinn_kalman_filter_tpu.ops.correlation_pallas import correlation_pallas
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3
from tests.port_parity import one_torch_thread  # noqa: F401

# Relative to max |reference|: a mean of C f32 products, summed in another
# order.
TOL = 1e-5


def _features(shape, seed=0):
  rng = np.random.default_rng(seed)
  return (rng.standard_normal(shape).astype(np.float32),
          rng.standard_normal(shape).astype(np.float32))


def _close(got, want):
  want = np.asarray(want)
  assert got.shape == want.shape
  assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize('shape', [(2, 7, 9, 3), (1, 5, 11, 8)])
def test_plain_matches_pallas_interpret(shape):
  f1, f2 = _features(shape)
  want = correlation_pallas(jnp.asarray(f1), jnp.asarray(f2), 1,
                            interpret=True)
  with torch.inference_mode():
    got = k3.correlation(torch.from_numpy(f1), torch.from_numpy(f2))
  _close(got, want)


@pytest.mark.parametrize('stride', [1, 2])
@pytest.mark.parametrize('shape', [(2, 7, 9, 3), (1, 9, 5, 8)])
def test_plain_matches_jax_correlation(shape, stride):
  f1, f2 = _features(shape, seed=1)
  want = jax_corr(jnp.asarray(f1), jnp.asarray(f2), stride)
  with torch.inference_mode():
    got = k3.correlation(torch.from_numpy(f1), torch.from_numpy(f2), stride)
  _close(got, want)


def test_zero_padding_outside_the_image():
  """A 1x1 image: only the centre shift (index 24) sees f2."""
  f1 = torch.tensor([[[[2.0, 4.0]]]])
  f2 = torch.tensor([[[[3.0, 5.0]]]])
  with torch.inference_mode():
    out = k3.correlation(f1, f2)
  want = torch.zeros((1, 1, 1, 49))
  want[..., 24] = (2 * 3 + 4 * 5) / 2
  assert torch.equal(out, want)


def test_wrapper_refuses_gradients_and_other_devices():
  f = torch.zeros((1, 4, 4, 3), requires_grad=True)
  with pytest.raises(RuntimeError, match='training slice'):
    k3.correlation(f, f)
  m = torch.empty((1, 4, 4, 3), device='meta')
  with pytest.raises(ValueError, match='no kernel for device'):
    k3.correlation(m, m)


@pytest.mark.parametrize('case', ['both mapped', 'f2 unmapped', 'nested'])
def test_vmap_rule_folds_the_stack_into_one_call(case, monkeypatch):
  """``torch.func.vmap`` over a stack of three (B, H, W, C) inputs runs the
  cost volume once, at batch 3B, and equals both the per-draw loop and the
  JAX correlation of the stacked batch."""
  f1, f2 = _features((3, 2, 6, 5, 4), seed=3)
  if case == 'f2 unmapped':
    f2 = np.broadcast_to(f2[:1], f2.shape).copy()
  calls = []
  plain = k3.correlation_plain

  def spy(a, b, stride=1):
    calls.append(tuple(a.shape))
    return plain(a, b, stride)

  t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
  with torch.inference_mode():
    loop = torch.stack([k3.correlation(a, b) for a, b in zip(t1, t2)])
    monkeypatch.setattr(k3, 'correlation_plain', spy)
    if case == 'both mapped':
      got = torch.func.vmap(k3.correlation)(t1, t2)
    elif case == 'f2 unmapped':
      got = torch.func.vmap(k3.correlation, in_dims=(0, None))(t1, t2[0])
    else:   # a vmap inside a vmap folds both levels into the batch
      got = torch.func.vmap(torch.func.vmap(k3.correlation))(
          t1[:, :, None], t2[:, :, None])[:, :, 0]
  assert calls == [(6, 6, 5, 4)]
  assert got.shape == (3, 2, 6, 5, 49)
  assert (got - loop).abs().max() <= TOL * loop.abs().max()
  want = jax_corr(jnp.asarray(f1.reshape(6, 6, 5, 4)),
                  jnp.asarray(f2.reshape(6, 6, 5, 4)), 1)
  _close(got.reshape(6, 6, 5, 49), want)
