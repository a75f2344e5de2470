"""The port's likelihood (``core/likelihood.py``) against the JAX package's.

- The Gaussian closed form and the divergence of a linear function, as
  tests/test_likelihood.py checks the JAX side.
- The whole bits/dim on the MLP score model of tests/inverse_parity.py
  (4x4x1, batch 2, every parameter randomised), JAX's Rademacher probe
  handed to the port, both sides in f64: bpd to 1e-10 and the NFE exactly.
- One drift-plus-divergence evaluation of the tiny DDPM (nf 32, ch_mult
  (1, 2), 8x8, batch 2, every parameter randomised; through K1 and K2's
  forward-mode rules, their plain bodies here) against JAX's ``jax.jvp``,
  in f32: 1e-4 of max |JAX| (the U-Net's f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu import models as jax_mutils
from b_pinn_kalman_filter_tpu.core import likelihood as jax_likelihood
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu.data import get_data_inverse_scaler as jax_inv
from b_pinn_kalman_filter_tpu_torch.core import likelihood
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data.scalers import get_data_inverse_scaler
from b_pinn_kalman_filter_tpu_torch.models import convert, registry
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from tests import inverse_parity as ip
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

F64_TOL = 1e-10
TOL = 1e-4
MU0, S0 = 0.3, 0.4
# K1 and K2 sites of one forward of the tiny DDPM: its 8 res blocks' two
# convs and two norms each, and the upsampling conv.
SITES = {'conv3x3': 17, 'groupnorm_act': 16}


def test_bpd_matches_gaussian_closed_form():
  """With the exact score of N(MU0, S0^2) data the Rademacher estimate is
  exact (a diagonal Jacobian), so bpd is the closed form's (to the
  integration's 0.05, the JAX test's limit)."""
  sde = sde_lib.VPSDE(N=1000)

  def score_fn(x, t):
    a, std = sde.marginal_coef(t)
    var = a ** 2 * S0 ** 2 + std ** 2
    return -(x - (a * MU0)[:, None, None, None]) / var[:, None, None, None]

  fn = likelihood.get_likelihood_fn_from_score(
      sde, lambda x: x, hutchinson_type='Rademacher', rtol=1e-6, atol=1e-6)
  data = MU0 + S0 * torch.from_numpy(
      np.random.default_rng(1).standard_normal((4, 4, 4, 1)).astype(
          np.float32))
  bpd, z, nfe = fn(score_fn, data, generator=torch.Generator().manual_seed(0))
  n = 16
  flat = data.numpy().reshape(4, -1).astype(np.float64)
  logp = (-0.5 * n * np.log(2 * np.pi * S0 ** 2)
          - 0.5 * ((flat - MU0) ** 2).sum(-1) / S0 ** 2)
  want = -logp / np.log(2) / n + (7.0 - (-1.0))   # the identity scaler
  np.testing.assert_allclose(bpd.numpy(), want, rtol=0, atol=0.05)
  assert z.shape == data.shape and nfe > 0


def test_divergence_estimator_is_exact_for_a_linear_fn():
  """For f(x) = A x, eps^T A eps for each draw (to f32 rounding), and its
  mean over draws near tr(A); the primal is f(x)."""
  a = torch.from_numpy(np.random.default_rng(0).random((6, 6)).astype(
      np.float32))

  def f(x, t):
    return (x.reshape(x.shape[0], -1) @ a.T).reshape(x.shape)

  x = torch.from_numpy(np.random.default_rng(1).standard_normal(
      (2, 2, 3, 1)).astype(np.float32))
  g = torch.Generator().manual_seed(0)
  vals = []
  for _ in range(400):
    eps = (torch.randint(0, 2, x.shape, generator=g) * 2 - 1).float()
    drift, div = likelihood.get_drift_div_fn(f)(x, None, eps)
    e = eps.reshape(2, -1)
    torch.testing.assert_close(div, ((e @ a.T) * e).sum(-1))
    torch.testing.assert_close(drift, f(x, None))
    vals.append(likelihood.get_div_fn(f)(x, None, eps).numpy())
  np.testing.assert_allclose(np.mean(vals), np.trace(a.numpy()), rtol=0.1)


def test_bpd_on_the_mlp_matches_jax_in_f64():
  j_config, p_config = ip.mlp_configs()
  j_model, params = ip.jax_model(j_config)
  p_model = ip.torch_model(p_config, params)
  data = ip.origin().astype(np.float64)
  with jax.enable_x64(True):
    rng = jax.random.PRNGKey(4)
    eps = jax.random.rademacher(rng, data.shape, dtype=jnp.float64)
    j_fn = jax_likelihood.get_likelihood_fn(
        jax_sde.get_sde(j_config)[0], j_model, jax_inv(j_config))
    want_bpd, want_z, want_nfe = j_fn(rng, params, jnp.asarray(data))
    want_bpd, want_z = np.asarray(want_bpd), np.asarray(want_z)
  p_fn = likelihood.get_likelihood_fn(
      sde_lib.get_sde(p_config)[0], p_model,
      get_data_inverse_scaler(p_config))
  bpd, z, nfe = p_fn(None, torch.from_numpy(data),
                     epsilon=torch.from_numpy(np.array(eps)))
  assert bpd.dtype == torch.float64 and bpd.shape == (2,)
  assert np.abs(bpd.numpy() - want_bpd).max() <= F64_TOL * np.abs(
      want_bpd).max()
  assert np.abs(z.numpy() - want_z).max() <= F64_TOL * np.abs(want_z).max()
  assert nfe == int(want_nfe) and nfe > 20


def test_hutchinson_types_draw_from_the_generator():
  """Rademacher signs and Gaussian probes come from the generator: the
  same seed, the same bpd; an unknown type raises."""
  j_config, p_config = ip.mlp_configs()
  _, params = ip.jax_model(j_config)
  p_model = ip.torch_model(p_config, params)
  sde = sde_lib.get_sde(p_config)[0]
  data = torch.from_numpy(ip.origin())
  for kind in ('Rademacher', 'Gaussian'):
    fn = likelihood.get_likelihood_fn(sde, p_model, lambda x: x, kind,
                                      rtol=1e-3, atol=1e-3)
    a = fn(None, data, generator=torch.Generator().manual_seed(5))
    b = fn(None, data, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and a[2] == b[2]
    assert torch.isfinite(a[0]).all()
  with pytest.raises(NotImplementedError):
    likelihood.get_likelihood_fn(sde, p_model, lambda x: x, 'Cauchy')


@pytest.fixture(scope='module')
def tiny_ddpm():
  j_config, p_config = port_parity.tiny_configs()
  j_apply, params = port_parity.jax_tiny_model(j_config, seed=6)
  return j_config, p_config, params


def test_one_unet_drift_and_divergence_matches_jax(tiny_ddpm, monkeypatch):
  """The probability-flow drift and the Hutchinson divergence of the tiny
  DDPM at t = 0.37, batch 2, one Rademacher probe: the port's one
  forward-mode pass through the kernel sites (K1 twice a site, K2 and
  its JVP once a site, their plain bodies here) against JAX's drift and
  ``get_div_fn``."""
  j_config, p_config, params = tiny_ddpm
  rng = np.random.default_rng(7)
  x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
  eps = np.sign(rng.standard_normal(x.shape)).astype(np.float32)
  t = np.full((2,), 0.37, np.float32)

  j_model = jax_mutils.create_model(j_config)
  j_sde = jax_sde.get_sde(j_config)[0]
  j_score = jax_mutils.get_score_fn(j_sde, j_model, params, train=False,
                                    continuous=True)

  def j_drift(xx, tt):
    return j_sde.reverse(j_score, probability_flow=True).sde(xx, tt)[0]

  want_drift, want_div = jax.jit(lambda xx, tt, ee: (
      j_drift(xx, tt), jax_likelihood.get_div_fn(j_drift)(xx, tt, ee)))(
          jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))

  p_model = registry.create_model(p_config, device='cpu')
  convert.params_from_jax(params, p_model)
  p_sde = sde_lib.get_sde(p_config)[0]
  p_score = registry.get_score_fn(p_sde, p_model, train=False,
                                  continuous=True)
  rsde = p_sde.reverse(p_score, probability_flow=True)
  # The Functions' rules on the CPU: K1's terms through ``_conv`` with use
  # 'jvp', K2's through ``groupnorm_act_jvp``.
  calls = {'conv3x3': 0, 'groupnorm_act_jvp': 0}
  conv, gn_jvp = k1._conv, k2.groupnorm_act_jvp

  def counted_conv(x, kernel, bias, use):
    calls['conv3x3'] += use == 'jvp'
    return conv(x, kernel, bias, use)

  def counted_gn_jvp(*args):
    calls['groupnorm_act_jvp'] += 1
    return gn_jvp(*args)

  monkeypatch.setattr(k1, '_conv', counted_conv)
  monkeypatch.setattr(k2, 'groupnorm_act_jvp', counted_gn_jvp)
  with torch.no_grad():
    drift, div = likelihood.get_drift_div_fn(
        lambda xx, tt: rsde.sde(xx, tt)[0])(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(eps))
  for got, want in ((drift, want_drift), (div, want_div)):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
  # Every K1 and K2 site carried its tangent through the Function's rule
  # (the first and last convs and the final GroupNorm stay plain, as in
  # JAX).
  assert calls == {'conv3x3': SITES['conv3x3'],
                   'groupnorm_act_jvp': SITES['groupnorm_act']}
