"""The port's observation operators, observation SDE, mask streams and NC
data against the JAX package's; and DPS and the controlled sampler by
RK45 (``tests/test_torch_inverse.py``'s cases, run here to balance the
files' times).

Limits: 1e-6 relative to max |JAX| for the operators (a product or a
9-tap sum in f32); masks, the smooth field and the dataset items exactly
(the same numpy draws)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu import configs as jax_configs
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu.data import datasets as jax_datasets
from b_pinn_kalman_filter_tpu.inverse import obsv_sde as jax_obsv
from b_pinn_kalman_filter_tpu.inverse import operators as jax_ops
from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.data import datasets
from b_pinn_kalman_filter_tpu_torch.inverse import obsv_sde, operators
from tests.port_parity import one_torch_thread  # noqa: F401
from tests.test_torch_inverse import check_sampler_matches_jax
from tests.test_torch_inverse import setup  # noqa: F401

TOL = 1e-6


def _rel(got, want):
  want = np.asarray(want)
  return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _mask(h=6, w=5, seed=0):
  return (np.random.default_rng(seed).random((h, w, 1)) > 0.5).astype(
      np.float32)


def _image(shape, seed=1):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def test_inpaint_operator():
  mask = _mask()
  j_op = jax_ops.InpaintOperator(mask=mask)
  p_op = operators.InpaintOperator(mask=mask)
  x = _image((2, 6, 5, 3))
  for keep_shape in (True, False):
    for invert in (False, True):
      want = j_op(jnp.asarray(x), keep_shape=keep_shape, invert=invert)
      got = p_op(torch.tensor(x), keep_shape=keep_shape, invert=invert)
      assert got.shape == want.shape
      np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  y = p_op(torch.tensor(x), keep_shape=False)
  np.testing.assert_array_equal(
      p_op.observation_mask(y).numpy(),
      np.asarray(j_op.observation_mask(jnp.asarray(y.numpy()))))
  np.testing.assert_array_equal(
      p_op.project_observed(y, (6, 5)).numpy(),
      np.asarray(j_op.project_observed(jnp.asarray(y.numpy()), (6, 5))))
  np.testing.assert_array_equal(p_op.to_matrix((6, 5)),
                                j_op.to_matrix((6, 5)))
  for got, want in zip(p_op.decompose((6, 5)), j_op.decompose((6, 5))):
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('ndim', [2, 4])
def test_gaussian_filter(ndim):
  """The symmetric-boundary blur, on an (H, W) image and a (B, H, W, C)
  batch, and its 'valid' matrix."""
  j_op = jax_ops.GaussianFilter((5, 5), 1.5)
  p_op = operators.GaussianFilter((5, 5), 1.5)
  x = _image((9, 7) if ndim == 2 else (2, 9, 7, 3))
  assert _rel(p_op(torch.tensor(x)).numpy(), j_op(jnp.asarray(x))) <= TOL
  np.testing.assert_array_equal(p_op.to_matrix((8, 8)),
                                j_op.to_matrix((8, 8)))


def test_get_operator_blur_and_small_operators():
  config = configs.get_config('inverse/nc_ddpmpp_inpaint_dps')
  config.inverse.operator = 'blur'
  config.inverse.blur_kernel = 3
  op = operators.get_operator(config)
  assert isinstance(op, operators.GaussianFilter)
  assert op.get_kernel().shape == (3, 3) and op.std == 2.0
  x = _image((2, 4, 4, 1))
  assert _rel(operators.ScalerMult(2.5)(torch.tensor(x)).numpy(),
              jax_ops.ScalerMult(2.5)(jnp.asarray(x))) <= TOL
  m = _image((8, 5), seed=2)
  x = _image((2, 2, 8), seed=3)
  assert _rel(operators.MatrixMult(m)(torch.tensor(x)).numpy(),
              jax_ops.MatrixMult(m)(jnp.asarray(x))) <= TOL
  mm = _image((2, 3, 4, 5), seed=4)
  v = _image((2, 3, 4), seed=5)
  assert _rel(operators.bcmm(torch.tensor(mm), torch.tensor(v)).numpy(),
              jax_ops.bcmm(jnp.asarray(mm), jnp.asarray(v))) <= TOL


def test_observe_with_given_noise():
  op = operators.InpaintOperator(mask=_mask())
  x = torch.tensor(_image((2, 6, 5, 1)))
  noise = torch.tensor(_image((2, 6, 5, 1), seed=7))
  y = operators.observe(x, op, sigma=0.3, noise=noise)
  np.testing.assert_allclose(y.numpy(), (op(x) + 0.3 * noise).numpy())
  g = torch.Generator().manual_seed(0)
  assert operators.observe(x, op, generator=g).shape == (2, 6, 5, 1)


def test_lobsvsde_observe_sampling():
  mask = _mask()
  x0 = _image((3, 6, 5, 2))
  z = _image((3, 6, 5, 2), seed=9)
  t = np.array([0.1, 0.5, 0.9], np.float32)
  j_op = jax_ops.InpaintOperator(mask=mask)
  p_op = operators.InpaintOperator(mask=mask)
  j = jax_obsv.LOBSVSDE(jax_sde.VPSDE(), j_op(jnp.asarray(x0), False), j_op)
  p = obsv_sde.LOBSVSDE(sde_lib.VPSDE(), p_op(torch.tensor(x0), False), p_op)
  want = j.observe_sampling(jnp.asarray(z), jnp.asarray(t))
  got = p.observe_sampling(torch.tensor(z), torch.tensor(t))
  assert _rel(got.numpy(), want) <= TOL
  mean, beta = p.marginal_prob(torch.tensor(z), torch.tensor(t))
  j_mean, j_beta = j.marginal_prob(jnp.asarray(z), jnp.asarray(t))
  assert _rel(mean.numpy(), j_mean) <= TOL
  assert _rel(beta.numpy(), j_beta) <= TOL
  config = configs.get_config('inverse/nc_ddpmpp_inpaint_dps')
  got_sde, eps = obsv_sde.get_obsvsde(config, p.y0, p_op)
  assert isinstance(got_sde.state_sde, sde_lib.VPSDE) and eps == 1e-3


@pytest.mark.parametrize('name', ['inverse/nc_ddpmpp_inpaint_dps',
                                  'inverse/nc_ddpmpp_rndinpaint_dps'])
def test_mask_streams(tmp_path, monkeypatch, name):
  """``inpaint`` (no MNIST here: uniform masks) and ``inpaint_rnd``, the
  first three masks of the operator's stream, as JAX draws them."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path))
  j_config = jax_configs.get_config(name)
  p_config = configs.get_config(name)
  for c in (j_config, p_config):
    c.data.image_size = 8
  j_op = jax_ops.get_operator(j_config)
  p_op = operators.get_operator(p_config, device='cpu')
  for _ in range(3):
    np.testing.assert_array_equal(p_op.mask.numpy(), np.asarray(j_op.mask))
    assert p_op.mask.shape == (8, 8, 1)
    j_op.next()
    p_op.next()


def test_smooth_field_and_nc_dataset():
  """``_smooth_field`` at a small shape and the NC items of both splits
  (``land_cut`` 8, 16x16 crops)."""
  field = datasets.smooth_field(np.random.default_rng(3), (20, 1, 40, 24), 8)
  want = jax_datasets._smooth_field(np.random.default_rng(3),
                                    (20, 1, 40, 24), 8)
  np.testing.assert_array_equal(field, want)
  data = field.astype(np.float32)
  for split in ('train', 'test'):
    got = datasets.NCDataset(data, 16, split, 8, 5)
    ref = jax_datasets.NCDataset(data, 16, split, 8, 5)
    assert len(got) == len(ref) == {'train': 16, 'test': 4}[split]
    for i in range(len(ref)):
      (img, label), (want_img, want_label) = got[i], ref[i]
      assert img.shape == (16, 16, 1) and label == want_label == 0
      np.testing.assert_array_equal(img, want_img)


def test_nc_branch_reads_the_npz_sibling(tmp_path, monkeypatch):
  """``get_dataset``'s NC branch on a small ``.nc.npz`` under the data
  directory (netCDF4 and the NetCDF-3 reader fail first): the first test
  batch as JAX's, and None for a missing file."""
  monkeypatch.setenv('BPKF_DATA_DIR', str(tmp_path))
  field = datasets.smooth_field(np.random.default_rng(0), (30, 1, 20, 12), 4)
  name = 'bsose_i122_2013to2017_1day_Theta.nc'
  np.savez(tmp_path / f'{name}.npz', THETA=field.astype(np.float32))
  j_config = jax_configs.get_config('inverse/nc_ddpmpp_inpaint_dps')
  p_config = configs.get_config('inverse/nc_ddpmpp_inpaint_dps')
  for c in (j_config, p_config):
    c.data.image_size, c.data.land_cut, c.training.batch_size = 8, 4, 3
  got = next(iter(datasets.get_dataset(p_config)[1]))
  want = next(iter(jax_datasets.get_dataset(j_config)[1]))
  np.testing.assert_array_equal(got[0], want[0])
  assert got[0].shape == (3, 8, 8, 1)
  assert datasets.load_netcdf(str(tmp_path / 'missing.nc'), 'THETA') is None
  np.testing.assert_array_equal(
      datasets.load_netcdf(str(tmp_path / name), 'THETA'),
      field.astype(np.float32))


@pytest.mark.parametrize('sampler', ['dps', 'controlled'])
def test_rk45_sampler_matches_jax(setup, sampler, monkeypatch):  # noqa: F811
  """Dormand–Prince in f64 on both sides: the sample to 1e-10, the NFE and
  the status exactly."""
  check_sampler_matches_jax(setup, sampler, 'RK45', monkeypatch)
