"""The port's square-root UKF, patching and UKF models against the JAX
package's ``kalman/`` (f32, CPU): ``patch``/``unpatch``, sigma points,
predict, update and a whole step under linear dynamics, the NS dynamics on
a stack of sigma points, and the measurement covariances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.kalman import dynamics as jax_dyn
from b_pinn_kalman_filter_tpu.kalman import patching as jax_patching
from b_pinn_kalman_filter_tpu.kalman import ukf as jax_ukf
from b_pinn_kalman_filter_tpu_torch.kalman import dynamics
from b_pinn_kalman_filter_tpu_torch.kalman import patching
from b_pinn_kalman_filter_tpu_torch.kalman import ukf
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

# Means and sqrt covariances, relative to max |reference|: QR and Cholesky
# of two LAPACK builds agree to rounding once the signs are canonical.
TOL = 1e-4


def _close(got, want, tol=TOL):
  want = np.asarray(want)
  got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
  assert got.shape == want.shape, (got.shape, want.shape)
  assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def test_patch_unpatch_match_jax():
  x = np.random.default_rng(0).random((2, 16, 16, 4)).astype(np.float32)
  want = jax_patching.patch(jnp.asarray(x), 4)
  got = patching.patch(_t(x), 4)
  _close(got, want, 0)
  _close(patching.unpatch(got, 4, 16, 4),
         jax_patching.unpatch(want, 4, 16, 4), 0)


def test_stacked_states_unpatch_one_by_one():
  """The channel is a state's outermost axis: S stacked states are S
  images, and unpatching the (S*N, n) stack as one array mixes them."""
  rng = np.random.default_rng(1)
  states = _t(rng.random((3, 64, 16)))
  one_by_one = torch.stack([patching.unpatch(s, 4, 16, 4) for s in states])
  _close(patching.unpatch_stack(states, 4, 16, 4), one_by_one, 0)
  _close(patching.patch_stack(one_by_one, 4), states, 0)
  as_one = patching.unpatch(states.reshape(3 * 64, 16), 4, 16, 4)
  assert not torch.equal(as_one, one_by_one[:, 0])


# -- the filter under linear dynamics ---------------------------------------

N, n = 3, 4


@pytest.fixture(scope='module')
def linear():
  rng = np.random.default_rng(2)
  A = (np.eye(n) * 0.9 + 0.05 * rng.standard_normal((n, n))).astype(
      np.float32)
  sqrt_q = np.linalg.cholesky(0.01 * np.eye(n)).astype(np.float32)
  R = (0.1 * np.eye(n) + 0.02 * np.diag(rng.random(n))).astype(np.float32)
  mean = rng.standard_normal((N, n)).astype(np.float32)
  L = rng.standard_normal((N, n, n)).astype(np.float32) * 0.3
  cov = (L @ L.transpose(0, 2, 1) + 0.5 * np.eye(n)).astype(np.float32)
  obs = rng.standard_normal((N, n)).astype(np.float32)

  def jax_dynamics(states):
    return states @ jnp.asarray(A).T, jnp.broadcast_to(jnp.asarray(sqrt_q),
                                                       (N, n, n))

  def jax_measure(states):
    return states, jnp.broadcast_to(jnp.asarray(R), (N, n, n))

  def torch_dynamics(states):
    return states @ _t(A).T, _t(sqrt_q).expand(N, n, n)

  def torch_measure(states):
    return states, _t(R).expand(N, n, n)

  w = ukf.merwe_weights(n)
  assert np.array_equal(w.wm, jax_ukf.merwe_weights(n).wm)
  return dict(
      w=w, mean=mean, cov=cov, obs=obs,
      jax=(jax_ukf.initialize_beliefs(jnp.asarray(mean), jnp.asarray(cov)),
           jax_dynamics, jax_measure),
      torch=(ukf.initialize_beliefs(_t(mean), _t(cov)), torch_dynamics,
             torch_measure))


def _close_belief(got, want):
  _close(got.mean, want.mean)
  _close(got.sqrt_cov, want.sqrt_cov)
  assert (torch.diagonal(got.sqrt_cov, dim1=-2, dim2=-1) >= 0).all()


def test_sigma_points_match_jax(linear):
  belief, _, _ = linear['torch']
  _close(ukf.sigma_points(belief, linear['w']),
         jax_ukf.sigma_points(linear['jax'][0], linear['w']))


def test_predict_matches_jax(linear):
  jb, jdyn, _ = linear['jax']
  tb, tdyn, _ = linear['torch']
  want, want_x = jax_ukf.predict(jb, linear['w'], jdyn)
  got, got_x = ukf.predict(tb, linear['w'], tdyn)
  _close_belief(got, want)
  _close(got_x, want_x)


def test_update_matches_jax(linear):
  jb, _, jmeas = linear['jax']
  tb, _, tmeas = linear['torch']
  w = linear['w']
  want = jax_ukf.update(jb, jax_ukf.sigma_points(jb, w), w,
                        jnp.asarray(linear['obs']), jmeas)
  got = ukf.update(tb, ukf.sigma_points(tb, w), w, _t(linear['obs']), tmeas)
  _close_belief(got, want)


def test_two_ukf_steps_match_jax(linear):
  jb, jdyn, jmeas = linear['jax']
  tb, tdyn, tmeas = linear['torch']
  for k in range(2):
    obs = linear['obs'] * (k + 1)
    jb = jax_ukf.ukf_step(jb, jnp.asarray(obs), linear['w'], jdyn, jmeas)
    tb = ukf.ukf_step(tb, _t(obs), linear['w'], tdyn, tmeas)
  _close_belief(tb, jb)


# -- the UKF models at the tiny PINN size ------------------------------------

def test_ns_dynamics_on_a_stack_of_sigma_points():
  jax_config, torch_config = port_parity.tiny_pinn_configs()
  rng = np.random.default_rng(3)
  fields = np.stack([rng.random((16, 16)),                   # f
                     0.2 * rng.standard_normal((16, 16)),    # u
                     0.2 * rng.standard_normal((16, 16)),    # v
                     0.05 * rng.standard_normal((16, 16))], -1)
  mean = jax_patching.patch(jnp.asarray(fields[None], jnp.float32), 4)
  sqrt_cov = np.tile(0.01 * np.eye(16, dtype=np.float32), (64, 1, 1))
  X = np.asarray(jax_ukf.sigma_points(
      jax_ukf.UKFBelief(mean=mean, sqrt_cov=jnp.asarray(sqrt_cov)),
      jax_ukf.merwe_weights(16)))[:5]                        # (5, 64, 16)
  jdyn = jax_dyn.NSDynamics(jax_config)
  want = jax.jit(jax.vmap(lambda s: jdyn(s)[0]))(jnp.asarray(X))
  got, sqrt_q = dynamics.NSDynamics(torch_config)(_t(X))
  _close(got, want, 1e-5)
  _close(sqrt_q, jdyn(jnp.asarray(X[0]))[1], 0)


def test_identity_measure_covariances_match_jax():
  jax_config, torch_config = port_parity.tiny_pinn_configs()
  rng = np.random.default_rng(4)
  states = rng.random((64, 16)).astype(np.float32)
  jm = jax_dyn.IdentityKFMeasure(jax_config)
  tm = dynamics.IdentityKFMeasure(torch_config)
  _close(tm(_t(states))[1], jm(jnp.asarray(states))[1], 0)
  flow = (0.05 + 0.1 * rng.random((1, 16, 16, 2))).astype(np.float32)
  pres = (0.05 + 0.1 * rng.random((1, 16, 16, 1))).astype(np.float32)
  jm.update_uncertainty(jnp.asarray(flow), jnp.asarray(pres))
  tm.update_uncertainty(_t(flow), _t(pres))
  obs, covar = tm(_t(states)[None])        # a stack of one state
  _close(obs[0], states, 0)
  _close(covar, jm(jnp.asarray(states))[1], 1e-6)


def test_observe_draws_from_the_generator():
  _, config = port_parity.tiny_pinn_configs()
  meas = dynamics.IdentityKFMeasure(config)
  f = torch.zeros((1, 64, 64, 1))
  a = meas.observe(torch.Generator().manual_seed(7), f)
  b = meas.observe(torch.Generator().manual_seed(7), f)
  assert torch.equal(a, b)
  assert abs(float(a.std()) - config.inverse.variance ** 0.5) < 5e-3
