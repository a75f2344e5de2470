"""Kernel K3 (FlowNet cost volume): the port's plain version against the JAX
package's XLA correlation and its Pallas kernel (interpret mode), on the
CPU; its gradients (the plain B1 and B2 of ``ops/correlation.py``, and
their composition to higher orders) against ``jax.vjp`` and nested
``jax.grad`` of the JAX correlation.  The CUDA kernels against the plain
versions: tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.ops.correlation import correlation as jax_corr
from b_pinn_kalman_filter_tpu.ops.correlation_pallas import correlation_pallas
from b_pinn_kalman_filter_tpu_torch.ops import _build
from b_pinn_kalman_filter_tpu_torch.ops import correlation as k3
from tests.port_parity import one_torch_thread  # noqa: F401

# Relative to max |reference|: a mean of C f32 products, summed in another
# order.
TOL = 1e-5
# Gradients, relative to max |JAX| (tests/port_parity.py): sums of 49 x C
# f32 products, and of products of those at the second order.
GRAD_TOL = 1e-4


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
  """Gradients are taken now (the tests below); what the wrappers refuse
  is a tensor on a device without a kernel, and a forward-mode tangent
  off the CPU (K3 and its backward have no forward-mode rule; K1 and K2
  have), which the helper ``_build.tangents`` raises for on any device
  but the CPU."""
  m = torch.empty((1, 4, 4, 3), device='meta')
  d = torch.empty((1, 4, 4, 49), device='meta')
  with pytest.raises(ValueError, match='no kernel for device'):
    k3.correlation(m, m)
  for fn in (k3.correlation_df1, k3.correlation_df2):
    with pytest.raises(ValueError, match='no kernel for device'):
      fn(d, m)
  with torch.autograd.forward_ad.dual_level():
    dual = torch.autograd.forward_ad.make_dual(m, torch.empty_like(m))
    with pytest.raises(NotImplementedError, match='forward-mode rule'):
      k3.correlation(dual, m)
    with pytest.raises(NotImplementedError, match='forward-mode rule'):
      _build.tangents('correlation_df1', None, dual)
    assert _build.tangents('x', torch.zeros(2), None) is False
    cpu = torch.autograd.forward_ad.make_dual(torch.zeros(2), torch.ones(2))
    assert _build.tangents('x', cpu) is True


def test_forward_mode_on_the_cpu_takes_the_plain_version():
  """The cost volume is bilinear: its JVP is K3(t1, f2) + K3(f1, t2)."""
  f1, f2 = map(torch.from_numpy, _features((2, 5, 6, 3), seed=9))
  t1, t2 = map(torch.from_numpy, _features((2, 5, 6, 3), seed=10))
  out, tangent = torch.func.jvp(k3.correlation, (f1, f2), (t1, t2))
  want = k3.correlation_plain(t1, f2) + k3.correlation_plain(f1, t2)
  assert torch.equal(out, k3.correlation_plain(f1, f2))
  assert (tangent - want).abs().max() <= TOL * want.abs().max()


def _grad_close(got, want):
  want = np.asarray(want)
  assert got.shape == want.shape
  assert np.abs(got.detach().numpy() - want).max() <= (
      GRAD_TOL * np.abs(want).max())


@pytest.mark.parametrize('shape', [(2, 6, 8, 4), (1, 7, 5, 3)])
def test_gradients_match_jax_vjp(shape):
  """df1 = B1(dout, f2) and df2 = B2(dout, f1), the plain versions and
  autograd through ``correlation``, against ``jax.vjp``."""
  f1, f2 = _features(shape, seed=4)
  dout = np.random.default_rng(5).standard_normal(
      shape[:3] + (49,)).astype(np.float32)
  _, vjp = jax.vjp(lambda a, b: jax_corr(a, b, 1), jnp.asarray(f1),
                   jnp.asarray(f2))
  want1, want2 = vjp(jnp.asarray(dout))
  t1, t2, td = (torch.from_numpy(a) for a in (f1, f2, dout))
  _grad_close(k3.correlation_df1_plain(td, t2), want1)
  _grad_close(k3.correlation_df2_plain(td, t1), want2)
  t1.requires_grad_()
  t2.requires_grad_()
  got1, got2 = torch.autograd.grad(k3.correlation(t1, t2), (t1, t2), td)
  _grad_close(got1, want1)
  _grad_close(got2, want2)


def test_second_order_matches_nested_jax_grad():
  """The gradient of ``sum(r * d/df1 sum(K3(f1, f2)**2))`` in f1 and f2:
  backward through K3's backward (B1, B2 and K3 again)."""
  shape = (2, 5, 7, 3)
  f1, f2 = _features(shape, seed=6)
  r = np.random.default_rng(7).standard_normal(shape).astype(np.float32)

  def jax_outer(a, b):
    g1 = jax.grad(lambda a_, b_: jnp.sum(jax_corr(a_, b_, 1) ** 2))(a, b)
    return jnp.sum(jnp.asarray(r) * g1)

  want = jax.grad(jax_outer, argnums=(0, 1))(jnp.asarray(f1),
                                             jnp.asarray(f2))
  t1, t2 = (torch.from_numpy(a).requires_grad_() for a in (f1, f2))
  (g1,) = torch.autograd.grad((k3.correlation(t1, t2) ** 2).sum(), (t1,),
                              create_graph=True)
  got = torch.autograd.grad((torch.from_numpy(r) * g1).sum(), (t1, t2))
  for g, w in zip(got, want):
    _grad_close(g, w)


def test_gradcheck_and_gradgradcheck_in_float64():
  """The three Functions' backwards against finite differences, to the
  second order (gradgradcheck differentiates B1 and B2 in turn)."""
  f1, f2 = (torch.from_numpy(a).double().requires_grad_()
            for a in _features((1, 2, 3, 2), seed=8))
  assert torch.autograd.gradcheck(k3.correlation, (f1, f2))
  assert torch.autograd.gradgradcheck(k3.correlation, (f1, f2))


def test_vmap_of_grad_is_one_call_per_function(monkeypatch):
  """``vmap(grad(...))`` over a stack of three: one forward call and one
  call each of B1 and B2, at batch 3B, equal to the loop."""
  f1, f2 = map(torch.from_numpy, _features((3, 2, 6, 5, 4), seed=11))

  def loss(a, b):
    return (k3.correlation(a, b) ** 2).sum()

  grad = torch.func.grad(loss, argnums=(0, 1))
  loop = [grad(a, b) for a, b in zip(f1, f2)]
  calls = []

  def spy(name, fn):
    def wrapped(a, b, *rest):
      calls.append((name, tuple(a.shape)))
      return fn(a, b, *rest)
    return wrapped

  monkeypatch.setattr(k3, 'correlation_plain',
                      spy('k3', k3.correlation_plain))
  for which in ('df1', 'df2'):
    monkeypatch.setitem(k3._PLAIN, which, spy(which, k3._PLAIN[which]))
  got = torch.func.vmap(grad)(f1, f2)
  assert sorted(calls) == [('df1', (6, 6, 5, 49)), ('df2', (6, 6, 5, 49)),
                           ('k3', (6, 6, 5, 4))]
  for i in range(2):
    want = torch.stack([g[i] for g in loop])
    assert (got[i] - want).abs().max() <= TOL * want.abs().max()


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


def test_aligned_copies_expanded_cotangents_and_reverse_mode_is_no_tangent():
  """Under nested ``create_graph`` the cotangents that reach K3, B1 and B2
  can be expanded (zero strides, as ``u.sum()``'s ones are) or views that
  start off a 16-byte boundary: ``_build.aligned`` hands the kernels a
  contiguous, aligned copy of the same values.  Reverse-mode nesting
  carries no forward-mode tangent, so ``_build.tangents`` does not fire."""
  ones = torch.ones(()).expand(2, 4, 4, 49)
  assert ones.stride() == (0, 0, 0, 0)
  view = torch.arange(2 * 4 * 4 * 50, dtype=torch.float32).reshape(
      2, 4, 4, 50)[..., 1:]
  for t in (ones, view):
    got = _build.aligned(t)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, t)
  f1 = torch.randn(1, 5, 5, 8, requires_grad=True)
  d1, = torch.autograd.grad(k3.correlation(f1, f1).sum(), f1,
                            create_graph=True)
  assert not _build.tangents('correlation', f1, d1)
