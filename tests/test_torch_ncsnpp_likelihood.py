"""The likelihood's drift and divergence at NCSN++ against the JAX
package's: ``tests/port_parity.py`` ``TINY_NCSNPP`` (Fourier embedding,
FIR resampling, BigGAN blocks, the residual input pyramid) under the VE
SDE, nf 32, every flax parameter randomised, at t = 0.37, batch 2, one
Rademacher probe, in f32: the port's one forward-mode pass (K1 on x and
on its tangent, K2 and the K2 JVP at every site, their plain bodies here;
the FIR ops as ``F.conv2d``) against JAX's drift and ``get_div_fn``.
Limit: 1e-4 of max |JAX|, as ``test_torch_likelihood.py`` holds the
DDPM.  One JAX program, built through ``jax.eval_shape`` of the init; the
file holds one test, so that xdist's ``loadfile`` hands it out last."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from b_pinn_kalman_filter_tpu import models as jax_mutils
from b_pinn_kalman_filter_tpu.core import likelihood as jax_likelihood
from b_pinn_kalman_filter_tpu.core import sde as jax_sde
from b_pinn_kalman_filter_tpu_torch.core import likelihood
from b_pinn_kalman_filter_tpu_torch.core import sde as sde_lib
from b_pinn_kalman_filter_tpu_torch.models import convert, layers, registry
from b_pinn_kalman_filter_tpu_torch.ops import conv3x3 as k1
from b_pinn_kalman_filter_tpu_torch.ops import groupnorm as k2
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
# TINY_NCSNPP's nf 8 leaves every conv under K1's 32-channel guard: at 32
# (32 and 64 channels) the resblocks' convs are K1 sites.
NF = 32


def test_ncsnpp_drift_and_divergence_match_jax(monkeypatch):
  j_config, p_config = port_parity.tiny_ncsnpp_configs('ve')
  for config in (j_config, p_config):
    config.model.nf = NF
  _, params = port_parity.jax_tiny_model(j_config, seed=3)
  rng = np.random.default_rng(11)
  x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
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
  assert isinstance(p_sde, sde_lib.VESDE)
  rsde = p_sde.reverse(registry.get_score_fn(p_sde, p_model, train=False,
                                             continuous=True),
                       probability_flow=True)
  calls = {'forward': 0, 'jvp': 0, 'groupnorm_act_jvp': 0}
  conv, gn_jvp = k1._conv, k2.groupnorm_act_jvp

  def counted_conv(x, kernel, bias, use):
    calls[use] = calls.get(use, 0) + 1
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
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
  # Every K1 site took its tangent through K1's rule, and every fused
  # GroupNorm + act (the resblocks') the K2 JVP.
  fused = sum(isinstance(m, layers.GroupNorm) and m.kernels
              and m.act in layers.FUSABLE_ACTS for m in p_model.modules())
  assert calls['forward'] == calls['jvp'] > 0
  assert calls['groupnorm_act_jvp'] == fused > 0
