"""The slice as a whole: B-PINN measurement + square-root UKF cycles of the
port against the JAX package's ``PINN_KF``, from the same B-PINN posterior,
the same posterior draws and the same observations (f32, CPU, the tiny PINN
config of tests/test_ukf.py: 16x16, two pyramid levels, 64 filters of
dimension 16).

The JAX draws are replayed: ``jax.random.split(rng, 8)`` and one
``bayes.sample_params`` per key, which equals the vmapped draws of
``bayes.sample_uvp``, converted by ``convert.draw_from_jax``.
(``sample_params`` folds ``hash(key)`` into the key, and Python salts
string hashes per process; the module fixture ``unsalted_jax_draws`` puts
a salt-free ``hash`` into that module's globals, so the JAX draws, and the
results compared here, are the same in every process.)"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.kalman.ukf_lib import PINN_KF as JaxPINN_KF
from b_pinn_kalman_filter_tpu.ops import ns_step as jax_ns
from b_pinn_kalman_filter_tpu.pinn import bayes as jax_bayes
from b_pinn_kalman_filter_tpu.pinn import pinn as jax_pinn
from b_pinn_kalman_filter_tpu_torch.data.ns_rollout import ns_rollout
from b_pinn_kalman_filter_tpu_torch.kalman import ukf_lib
from b_pinn_kalman_filter_tpu_torch.models import convert
from b_pinn_kalman_filter_tpu_torch.pinn import bayes
from b_pinn_kalman_filter_tpu_torch.pinn import pinn as torch_pinn
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

# The filtered state after two cycles, relative to max |reference| per
# channel: two cycles of 8 PINN forwards, QR and Cholesky, each within
# 1e-5 to 1e-4 (tests/test_torch_flownet.py, tests/test_torch_ukf.py); the
# largest error seen is 3.1e-5 (in u).
TOL = 1e-4
PREDICT_DT = 1.7   # data.dt of pinn/pinn_pde


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want):
  want = np.asarray(want)
  return np.abs(got.numpy() - want).max() / np.abs(want).max()


# The JAX measurement is PINN_KF._measure_impl written out: bayes.sample_uvp
# draws ``sample_params`` for each key of ``jax.random.split(rng, 8)``
# (vmapped) and applies the PINN to each draw.  Written out, the draws come
# out of the same program, which is compiled once, at XLA's lowest backend
# optimisation level: the 123 threefry draws of the tiny PINN's posterior
# take most of the file's time to trace and compile.
_FAST_COMPILE = {'xla_backend_optimization_level': 0,
                 'xla_llvm_disable_expensive_passes': True}


@pytest.fixture(scope='module')
def unsalted_jax_draws():
  """``bayes.sample_params`` of the JAX package with ``hash`` replaced, in
  its module's globals only, by CRC-32, which no process salts: its draws
  no longer depend on ``PYTHONHASHSEED``.  The JAX file is not edited."""
  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(jax_bayes, 'hash', lambda key: zlib.crc32(key.encode()),
                  raising=False)
    yield


@pytest.fixture(scope='module')
def slice_pair(unsalted_jax_draws):
  jax_config, torch_config = port_parity.tiny_pinn_configs()
  params = port_parity.randomized_params(
      port_parity.pinn_param_shapes(jax_config), seed=1)
  jax_model = port_parity.jax_pinn(jax_config)
  jax_bparams = jax.jit(lambda p: jax_bayes.make_bpinn_params(
      p, jax_config, pretrained=True))(params)
  jax_kf = JaxPINN_KF(jax_config, jax_model, jax_bparams)
  port_model = torch_pinn.PINN(torch_config).eval()
  port_bparams = convert.bpinn_params_from_jax(jax_bparams, port_model)

  def measure_and_draws(rng, bparams, f1, f2, x, y, t):
    """The 8 draws of ``rng``, PINN_KF's measurement from them, and the
    advected-field statistics of ``bayes.predict`` (its body, written out
    on the same draws)."""
    draws = jax.vmap(jax_bayes.sample_params, in_axes=(0, None))(
        jax.random.split(rng, 8), bparams)
    flows, press = jax.vmap(lambda p: jax_model.apply(
        {'params': p}, f1, f2, x, y, t, size=(16, 16), train=False))(draws)
    flows = flows[-1]
    f_pred = jax.vmap(lambda u: jax_pinn.pinn_step(f2, u, PREDICT_DT))(flows)
    return draws, (flows.mean(axis=0), flows.std(axis=0),
                   press.mean(axis=0), press.std(axis=0)), (
                       f_pred.mean(axis=0), f_pred.std(axis=0))

  jitted = jax.jit(measure_and_draws, compiler_options=_FAST_COMPILE)

  def measure(rng, f1, f2, x, y, t):
    """(JAX measurement, the same draws as port draws, advected field)."""
    draws, measurement, advected = jitted(
        rng, jax_bparams, *map(jnp.asarray, (f1, f2, x, y, t)))
    draws = jax.tree_util.tree_map(np.asarray, draws)
    port_draws = [convert.draw_from_jax(
        jax.tree_util.tree_map(lambda a, i=i: a[i], draws), port_model)
                  for i in range(8)]
    return measurement, port_draws, advected

  return dict(torch_config=torch_config, jax_kf=jax_kf, measure=measure,
              jax_bparams=jax_bparams, port_model=port_model,
              port_bparams=port_bparams)


def _initial_state(seed=5):
  rng = np.random.default_rng(seed)
  f0 = rng.random((1, 16, 16, 1)).astype(np.float32)
  v0 = (0.2 * rng.standard_normal((1, 16, 16, 2))).astype(np.float32)
  p0 = (0.05 * rng.standard_normal((1, 16, 16, 1))).astype(np.float32)
  return f0, v0, p0


def test_two_cycles_match_jax(slice_pair):
  """``PINN_KF.__call__`` of both packages, twice; the JAX one is handed
  its measurement, computed beside the draws."""
  s = slice_pair
  f0, v0, p0 = _initial_state()
  jax_kf = s['jax_kf']
  port_kf = ukf_lib.PINN_KF(s['torch_config'], s['port_model'],
                            s['port_bparams'])
  jax_kf.initialize(*map(jnp.asarray, (f0, v0, p0)))
  port_kf.initialize(*map(_t, (f0, v0, p0)))

  _, _, x, y, _ = port_parity.pinn_inputs()
  rng = jax.random.PRNGKey(3)
  noise = np.random.default_rng(6)
  for cycle in range(2):
    rng, mc_rng = jax.random.split(rng)
    t = np.asarray([1.0 + cycle], np.float32)
    f_obs = (f0 + 0.1 * noise.standard_normal(f0.shape)).astype(np.float32)
    measurement, draws, _ = s['measure'](mc_rng, jax_kf.f_prev, f_obs, x, y,
                                         t)
    jax_kf._measure = lambda *args, m=measurement, **kwargs: m
    want = jax_kf(mc_rng, *map(jnp.asarray, (x, y, t, f_obs)))
    got = port_kf(*map(_t, (x, y, t, f_obs)), draws=draws)

  errors = [_rel(got[..., c], np.asarray(want)[..., c]) for c in range(4)]
  assert max(errors) <= TOL, errors
  assert np.isfinite(got.numpy()).all()
  S = port_kf.ukf.belief.sqrt_cov
  assert torch.isfinite(S).all()
  assert (torch.diagonal(S, dim1=-2, dim2=-1) >= 0).all()


def test_measurement_and_predict_match_jax(slice_pair):
  """One B-PINN measurement (mean and std over the 8 draws of the flow and
  the pressure) and ``bayes.predict`` (the same, and of the advected
  field)."""
  s = slice_pair
  f1, f2, x, y, t = port_parity.pinn_inputs(seed=2)
  want, draws, advected = s['measure'](jax.random.PRNGKey(4), f1, f2, x, y,
                                       t)
  port_kf = ukf_lib.PINN_KF(s['torch_config'], s['port_model'],
                            s['port_bparams'])
  port_kf.f_prev = _t(f1)
  got = port_kf.measure(*map(_t, (x, y, t, f2)), draws=draws)
  for g, w in zip(got, want):
    assert _rel(g, w) <= 1e-4
  with torch.inference_mode():
    flow, pres, f_mean, flow_std, pres_std, f_std = bayes.predict(
        s['port_model'], s['port_bparams'], *map(_t, (f1, f2, x, y, t)),
        dt=PREDICT_DT, n=8, draws=draws)
  for g, w in zip((flow, flow_std, pres, pres_std, f_mean, f_std),
                  want + advected):
    assert _rel(g, w) <= 1e-4


def test_vmapped_draws_equal_a_per_draw_loop(slice_pair):
  """``bayes.sample_uvp`` runs its draws as one vmapped forward; the same
  draws one ``functional_call`` at a time give the same flows and
  pressures (1e-5 relative: the vmapped convolutions are grouped ones,
  summed in another order), and a generator gives the draws it would
  hand in."""
  s = slice_pair
  model = s['port_model']
  args = tuple(map(_t, port_parity.pinn_inputs(seed=7)))
  draws = [bayes.sample_params(torch.Generator().manual_seed(11),
                               s['port_bparams'])]
  draws += [bayes.sample_params(torch.Generator().manual_seed(12 + i),
                                s['port_bparams']) for i in range(2)]
  with torch.inference_mode():
    flows, press = bayes.sample_uvp(model, s['port_bparams'], *args, n=3,
                                    size=(16, 16), draws=draws)
    loop = [torch.func.functional_call(model, d, args, {'size': (16, 16)})
            for d in draws]
    again, _ = bayes.sample_uvp(model, s['port_bparams'], *args, n=1,
                                size=(16, 16),
                                generator=torch.Generator().manual_seed(11))
  assert flows.shape == (3, 1, 16, 16, 2) and press.shape == (3, 1, 16, 16, 1)
  want_flows = torch.stack([out[0][-1] for out in loop])
  want_press = torch.stack([out[1] for out in loop])
  for got, want in ((flows, want_flows), (press, want_press)):
    assert _rel(got, want.numpy()) <= 1e-5
  assert _rel(again, flows[:1].numpy()) <= 1e-5


def test_own_draws_are_seeded_and_differ_per_draw(slice_pair):
  s = slice_pair
  draw = lambda seed: bayes.sample_params(torch.Generator().manual_seed(seed),
                                          s['port_bparams'])
  a, b = draw(0), draw(0)
  assert a.keys() == dict(s['port_model'].named_parameters()).keys()
  assert all(torch.equal(a[k], b[k]) for k in a)
  c = draw(1)
  assert not torch.equal(a['flownet.FinalUpsample_0.ConvUp_0.Conv_0.kernel'],
                         c['flownet.FinalUpsample_0.ConvUp_0.Conv_0.kernel'])


def test_bpinn_converter_raises_on_stray_and_missing_leaves(slice_pair):
  s = slice_pair
  tree = jax.tree_util.tree_map(np.asarray, s['jax_bparams'])
  stray = dict(tree, extra={'mu': {}, 'rho': {}})
  with pytest.raises(ValueError, match='keys'):
    convert.bpinn_params_from_jax(stray, s['port_model'])
  missing = {k: dict(v) for k, v in tree.items()}
  missing['pressurenet']['rho'] = dict(missing['pressurenet']['rho'])
  del missing['pressurenet']['rho']['Conv_1']
  with pytest.raises(ValueError, match='pressurenet.rho.*Conv_1.kernel'):
    convert.bpinn_params_from_jax(missing, s['port_model'])


def test_rollout_matches_the_jax_stepping_path():
  """The port's rollout against the JAX package's stepping loop (the
  jnp stepper, then damping), at 16x16 over 4 frames."""
  frames = ns_rollout(4, 16, 16, seed=3, device='cpu').numpy()
  d, u, v, p = (jnp.asarray(frames[0, c])[None] for c in range(2, 6))
  for i in range(1, 4):
    u, v = jax_ns.update_velocity(u, v, p, 0.0025, 1 / 16)
    p = jax_ns.update_pressure(u, v, p, 0.0025, 1 / 16)
    d = jax_ns.update_density(d, u, v, 0.0025, 1 / 16)
    u, v, p = u * 0.99, v * 0.99, p * 0.95
    for c, field in zip(range(2, 6), (d, u, v, p)):
      want = np.asarray(field[0])
      assert np.abs(frames[i, c] - want).max() <= 1e-5 * np.abs(want).max()
  xs, ys = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16))
  np.testing.assert_allclose(frames[2, 0], xs, atol=1e-7)
  np.testing.assert_allclose(frames[2, 1], ys, atol=1e-7)


def test_run_writes_its_outputs(slice_pair, tmp_path):
  """The ``ukf`` entry point end to end on the CPU: finite predictions of
  the right shape, and the f-MSE it writes is the one it returns."""
  config = slice_pair['torch_config']
  seconds = []
  mse = ukf_lib.run(config, str(tmp_path), n_steps=2, device='cpu',
                    cycle_seconds=seconds)
  preds = np.load(tmp_path / 'ukf_preds.npy')
  gts = np.load(tmp_path / 'ukf_gts.npy')
  assert preds.shape == gts.shape == (2, 16, 16)
  assert np.isfinite(preds).all() and len(seconds) == 2
  assert float((tmp_path / 'ukf_mse.txt').read_text()) == mse
  belief = np.load(tmp_path / 'ukf_belief.npz')
  assert belief['mean'].shape == (64, 16)
  assert belief['sqrt_cov'].shape == (64, 16, 16)
  assert mse == pytest.approx(float(np.mean((preds - gts) ** 2)))
