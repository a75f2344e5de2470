"""The port's SDEs against the JAX package's on shared numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu_torch.core import sde as torch_sde
from tests.port_parity import one_torch_thread  # noqa: F401


SDES = {
    'vp': dict(cls='VPSDE', kw=dict(beta_min=0.1, beta_max=20, N=1000)),
    'subvp': dict(cls='subVPSDE', kw=dict(beta_min=0.1, beta_max=20, N=1000)),
    've': dict(cls='VESDE', kw=dict(sigma_min=0.01, sigma_max=50, N=1000)),
}
# atol 1e-6 for values of order one; prior_logp is of order 1e2, where one
# f32 rounding is ~1e-5, so it is held at rtol 1e-6 as well.
ATOL = 1e-6
RTOL = 1e-6


def _pair(name):
  spec = SDES[name]
  return (getattr(jax_sde, spec['cls'])(**spec['kw']),
          getattr(torch_sde, spec['cls'])(**spec['kw']))


def _inputs(seed=0):
  rng = np.random.default_rng(seed)
  x = rng.standard_normal((4, 3, 3, 2)).astype(np.float32)
  t = np.asarray([1e-3, 0.25, 0.5, 1.0], np.float32)
  return x, t


def _close(got, want, rtol=0.0):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                             rtol=rtol)


def _score(xp):
  """An analytic score shared by both sides: sin(x) * (1 + t)."""
  def score(x, t):
    return xp.sin(x) * (1 + t).reshape(-1, 1, 1, 1)
  return score


@pytest.mark.parametrize('name', sorted(SDES))
def test_sde(name):
  j, p = _pair(name)
  x, t = _inputs()
  jd, jg = j.sde(jnp.asarray(x), jnp.asarray(t))
  pd, pg = p.sde(torch.from_numpy(x), torch.from_numpy(t))
  _close(pd, jd)
  _close(pg, jg)


@pytest.mark.parametrize('name', sorted(SDES))
def test_marginal_prob(name):
  j, p = _pair(name)
  x, t = _inputs(1)
  jm, js = j.marginal_prob(jnp.asarray(x), jnp.asarray(t))
  pm, ps = p.marginal_prob(torch.from_numpy(x), torch.from_numpy(t))
  _close(pm, jm)
  _close(ps, js)


@pytest.mark.parametrize('name', sorted(SDES))
def test_discretize(name):
  j, p = _pair(name)
  x, t = _inputs(2)
  jf, jG = j.discretize(jnp.asarray(x), jnp.asarray(t))
  pf, pG = p.discretize(torch.from_numpy(x), torch.from_numpy(t))
  _close(pf, jf)
  _close(pG, jG)


@pytest.mark.parametrize('probability_flow', [False, True])
@pytest.mark.parametrize('name', sorted(SDES))
def test_reverse(name, probability_flow):
  j, p = _pair(name)
  x, t = _inputs(3)
  jr = j.reverse(_score(jnp), probability_flow)
  pr = p.reverse(_score(torch), probability_flow)
  for method in ('sde', 'discretize'):
    ja, jb = getattr(jr, method)(jnp.asarray(x), jnp.asarray(t))
    pa, pb = getattr(pr, method)(torch.from_numpy(x), torch.from_numpy(t))
    # The reverse drift carries g^2 * score with g^2 up to ~1e4 (VE), so
    # it is held relative to its size.
    _close(pa, ja, rtol=RTOL)
    _close(pb, jb, rtol=RTOL)


@pytest.mark.parametrize('name', sorted(SDES))
def test_prior_logp(name):
  j, p = _pair(name)
  x, _ = _inputs(4)
  _close(p.prior_logp(torch.from_numpy(x)), j.prior_logp(jnp.asarray(x)),
         rtol=RTOL)


@pytest.mark.parametrize('sde_name,cls', [('vpsde', 'VPSDE'),
                                          ('subvpsde', 'subVPSDE'),
                                          ('vesde', 'VESDE')])
def test_get_sde(sde_name, cls):
  from b_pinn_kalman_filter_tpu_torch import configs
  config = configs.get_config('vp/cifar10_ddpmpp_continuous')
  config.training.sde = sde_name
  sde, eps = torch_sde.get_sde(config)
  assert type(sde).__name__ == cls and sde.N == config.model.num_scales
  assert eps == (1e-5 if cls == 'VESDE' else 1e-3)


def test_prior_sampling_shape_and_generator():
  sde = torch_sde.VESDE()
  a = sde.prior_sampling((2, 4, 4, 3),
                         generator=torch.Generator().manual_seed(0))
  b = sde.prior_sampling((2, 4, 4, 3),
                         generator=torch.Generator().manual_seed(0))
  assert a.shape == (2, 4, 4, 3) and torch.equal(a, b)
  assert 20 < float(a.std()) < 80          # sigma_max = 50
