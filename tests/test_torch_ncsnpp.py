"""The port's NCSN++ (``models/ncsnpp.py``) against the JAX package's, in
f32 on the CPU at ``tests/port_parity.py``'s ``TINY_NCSNPP``: the VE and
VP axis sets of the CIFAR-10 configs, every flax parameter randomised and
copied in by ``convert.params_from_jax`` (which refuses a leaf left over
on either side).  One jitted JAX forward a test (XLA's lowest
optimisation level), built through ``jax.eval_shape`` of the init; the file holds two tests, so that xdist's
``loadfile`` hands it out among the last files.  The output pyramids and
the DDPM resblocks: ``test_torch_ncsnpp_skip.py``,
``test_torch_ncsnpp_ddpm.py``.  Limit: 1e-4 of max |JAX|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch.models import convert, ncsnpp
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4


def check_variant(variant, seed=0):
  """The port's forward against JAX's on the same parameters and inputs;
  returns the port's model."""
  jax_config, torch_config = port_parity.tiny_ncsnpp_configs(variant)
  apply, params = port_parity.jax_tiny_model(
      jax_config, seed=seed, compiler_options=port_parity.FAST_COMPILE)
  x, labels = port_parity.ncsnpp_inputs(jax_config, seed)
  want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(labels)))
  model = ncsnpp.NCSNpp(torch_config).eval()
  convert.params_from_jax(params, model)
  with torch.no_grad():
    got = model(torch.from_numpy(x), torch.from_numpy(labels),
                train=False).numpy()
  assert got.shape == want.shape == x.shape and got.dtype == np.float32
  err = np.abs(got - want).max() / np.abs(want).max()
  assert err <= TOL, (variant, err)
  return model


@pytest.mark.parametrize('variant', ['ve', 'vp'])
def test_ncsnpp_matches_jax(variant):
  model = check_variant(variant)
  names = dict(model.named_parameters())
  if variant == 've':
    # The published axis set: a Fourier projection, FIR conv resampling of
    # the residual input pyramid, BigGAN blocks.
    assert 'GaussianFourierProjection_0.W' in names
    assert 'Downsample_0.Conv2d_0.weight' in names
  else:
    assert not any(n.startswith(('GaussianFourier', 'Downsample'))
                   for n in names)
