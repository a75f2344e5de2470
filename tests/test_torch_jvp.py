"""Forward mode through K1 and K2: the Functions' ``jvp`` rules (their
plain bodies on the CPU) against ``jax.jvp`` of the functions the TPU
kernels compute (the JAX package's XLA conv ``_direct_conv`` and
``_reference_groupnorm_act``), with tangents on x, the weights and the
bias, each alone and all together, under ``torch.func.jvp`` and
``torch.autograd.forward_ad``.  Also ``groupnorm_act_jvp_plain`` (the K2
JVP kernel's yardstick) against the same.

Limits, relative to max |JAX|: 2e-5 for the conv (f32 sums in another
order), 1e-5 for GroupNorm (f32 statistics).  bf16: the tangent in the
output's dtype, within 3e-2 of the f32 tangent (chip_smoke.py's bf16
limit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.ops import winograd as wg
from b_pinn_kalman_filter_tpu.ops.groupnorm_pallas import (
    _reference_groupnorm_act)
from b_pinn_kalman_filter_tpu_torch.ops import _build
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from tests.port_parity import one_torch_thread  # noqa: F401

CONV_TOL = 2e-5
GN_TOL = 1e-5
BF16_TOL = 3e-2
# Which inputs carry a tangent: x, the weights, the bias; all three.
WHICH = [(0,), (1,), (2,), (0, 1, 2)]


def _rel(got, want):
  want = np.asarray(want, np.float64)
  return float(np.abs(np.asarray(got, np.float64) - want).max()
               / np.abs(want).max())


def _draws(shapes, seed):
  rng = np.random.default_rng(seed)
  return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jvp_both(jax_fn, port_fn, primals, tangents, which):
  """(JAX's output and tangent, the port's under ``torch.func.jvp``), the
  inputs outside ``which`` held constant."""

  def restrict(fn, lib):
    def g(*args):
      full = list(map(lib, primals))
      for i, a in zip(which, args):
        full[i] = a
      return fn(*full)
    return g

  want = jax.jvp(restrict(jax_fn, jnp.asarray),
                 tuple(jnp.asarray(primals[i]) for i in which),
                 tuple(jnp.asarray(tangents[i]) for i in which))
  got = torch.func.jvp(restrict(port_fn, torch.from_numpy),
                       tuple(torch.from_numpy(primals[i]) for i in which),
                       tuple(torch.from_numpy(tangents[i]) for i in which))
  return want, got


@pytest.mark.parametrize('which', WHICH)
def test_conv3x3_jvp_matches_jax(which):
  shapes = [(2, 6, 5, 32), (3, 3, 32, 40), (40,)]
  primals = _draws(shapes, 1)
  primals[1] *= 0.1
  tangents = _draws(shapes, 2)
  (want_y, want_t), (got_y, got_t) = _jvp_both(
      wg._direct_conv, k1.conv3x3, primals, tangents, which)
  assert _rel(got_y.numpy(), want_y) <= CONV_TOL
  assert got_t.dtype == torch.float32
  assert _rel(got_t.numpy(), want_t) <= CONV_TOL


@pytest.mark.parametrize('act', list(k2.ACTS))
@pytest.mark.parametrize('which', WHICH)
def test_groupnorm_act_jvp_matches_jax(which, act):
  shapes = [(2, 4, 5, 64), (64,), (64,)]
  primals = _draws(shapes, 3)
  primals[0] = primals[0] * 2 + 0.5
  tangents = _draws(shapes, 4)

  def jax_fn(x, scale, bias):
    return _reference_groupnorm_act(x, scale, bias, 32, act, 1e-6)

  def port_fn(x, scale, bias):
    return k2.groupnorm_act(x, scale, bias, 32, act, 1e-6)

  (want_y, want_t), (got_y, got_t) = _jvp_both(jax_fn, port_fn, primals,
                                               tangents, which)
  assert _rel(got_y.numpy(), want_y) <= GN_TOL
  assert _rel(got_t.numpy(), want_t) <= GN_TOL
  # The plain JVP on its own, each absent tangent None.
  args = [torch.from_numpy(t) if i in which else None
          for i, t in enumerate(tangents)]
  plain = k2.groupnorm_act_jvp_plain(
      torch.from_numpy(primals[0]), args[0], torch.from_numpy(primals[1]),
      torch.from_numpy(primals[2]), args[1], args[2], 32, act, 1e-6)
  assert _rel(plain.numpy(), want_t) <= GN_TOL


def test_forward_ad_and_bf16_tangents():
  """``torch.autograd.forward_ad`` dual tensors take the same rules; in
  bf16 the tangents come out in bf16, near the f32 ones; each rule
  launches a term only for a tangent that is present."""
  fwd = torch.autograd.forward_ad
  x, w, b, dx = map(torch.from_numpy,
                    _draws([(2, 6, 5, 32), (3, 3, 32, 32), (32,),
                            (2, 6, 5, 32)], 5))
  w = w * 0.1
  scale = 1 + 0.1 * b
  want_t = torch.func.jvp(lambda a: k2.groupnorm_act(
      k1.conv3x3(a, w, b), scale, b), (x,), (dx,))[1]
  with fwd.dual_level():
    out = k2.groupnorm_act(k1.conv3x3(fwd.make_dual(x, dx), w, b), scale, b)
    got_t = fwd.unpack_dual(out).tangent
  torch.testing.assert_close(got_t, want_t)
  xb, dxb = x.bfloat16(), dx.bfloat16()
  y16, t16 = torch.func.jvp(lambda a: k2.groupnorm_act(
      k1.conv3x3(a, w, b), scale, b), (xb,), (dxb,))
  assert y16.dtype == t16.dtype == torch.bfloat16
  assert _rel(t16.float().numpy(), want_t.numpy()) <= BF16_TOL
  # bf16 with a bias tangent: the tangent stays in the output's dtype.
  t = torch.func.jvp(lambda a, c: k1.conv3x3(a, w, c), (xb, b),
                     (dxb, torch.ones_like(b)))[1]
  assert t.dtype == torch.bfloat16


def test_rules_launch_one_term_per_present_tangent(monkeypatch):
  """Only dx: one K1 term (use 'jvp'), one K2 JVP call; absent tangents
  arrive as None, not as materialised zeros."""
  calls = []
  conv, gn_jvp = k1._conv, k2.groupnorm_act_jvp
  monkeypatch.setattr(k1, '_conv', lambda *a: calls.append(a[3]) or conv(*a))
  monkeypatch.setattr(k2, 'groupnorm_act_jvp',
                      lambda *a: calls.append(('gn', a[1] is None,
                                               a[4] is None, a[5] is None))
                      or gn_jvp(*a))
  x, dx = torch.randn(1, 4, 4, 32), torch.randn(1, 4, 4, 32)
  w = torch.nn.Parameter(0.1 * torch.randn(3, 3, 32, 32))
  s = torch.nn.Parameter(torch.ones(32))
  with torch.no_grad():
    y, t = torch.func.jvp(lambda a: k2.groupnorm_act(k1.conv3x3(a, w), s, s),
                          (x,), (dx,))
  assert calls == ['forward', 'jvp', ('gn', False, True, True)]
  # No graph of the tangent's terms is kept (the rules run without grad).
  assert not t.requires_grad


def test_k3_still_refuses_a_tangent_off_the_cpu():
  """K1 and K2 take tangents on every device; K3 and its backward have no
  forward-mode rule and refuse a tangent off the CPU."""
  m = torch.empty((1, 4, 4, 3), device='meta')
  with torch.autograd.forward_ad.dual_level():
    dual = torch.autograd.forward_ad.make_dual(m, torch.empty_like(m))
    assert _build.has_tangent(dual) and _build.differentiated(dual)
    with pytest.raises(NotImplementedError, match='forward-mode rule'):
      _build.tangents('correlation', dual)
  assert not _build.differentiated(torch.zeros(2), None)
