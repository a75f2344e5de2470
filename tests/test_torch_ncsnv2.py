"""The port's NCSNv2 (``models/ncsnv2.py`` ``ncsnv2_64``) against the JAX
package's, in f32 on the CPU at nf 8 (``tests/port_parity.py``
``tiny_ncsn_configs``): at 16x16, and at 28x28, where the last stage
takes ``adjust_padding``.  Every flax parameter is randomised (the
norms' scales near 1) and copied in by ``convert.params_from_jax``, which
refuses a leaf left over on either side.  One jitted JAX forward a test
(XLA's lowest optimisation level), built through ``jax.eval_shape`` of the
init; the file holds two tests, so that xdist's ``loadfile`` hands it out
among the last files.  ``ncsn`` and the SMLD loss:
``test_torch_ncsn.py``; ``ncsnv2_128`` and ``ncsnv2_256``:
``test_torch_ncsnv2_large.py``.  Limit: 1e-4 of max |JAX|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from b_pinn_kalman_filter_tpu_torch.models import convert, registry
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4


def check_forward(name, size, seed=0):
  """The port's forward against JAX's on the same parameters and inputs;
  returns the port's model."""
  jax_config, torch_config = port_parity.tiny_ncsn_configs(name, size)
  apply, params = port_parity.jax_tiny_model(
      jax_config, seed=seed, compiler_options=port_parity.FAST_COMPILE,
      scales=port_parity.NCSN_SCALES)
  x, labels = port_parity.ncsn_inputs(jax_config, seed)
  want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(labels)))
  model = registry.get_model(name)(torch_config).eval()
  convert.params_from_jax(params, model)
  with torch.no_grad():
    got = model(torch.from_numpy(x), torch.from_numpy(labels),
                train=False).numpy()
  assert got.shape == want.shape == x.shape and got.dtype == np.float32
  err = np.abs(got - want).max() / np.abs(want).max()
  assert err <= TOL, (name, size, err)
  return model


@pytest.mark.parametrize('size', [16, 28])
def test_ncsnv2_64_matches_jax(size):
  model = check_forward('ncsnv2_64', size, seed=size)
  names = dict(model.named_parameters())
  assert 'ResidualBlock_2.ConvMeanPool_0.NCSNConv_0.Conv_0.kernel' in names
  assert 'RefineBlock_3.MSFBlock_0.NCSNConv_1.Conv_0.bias' in names
  assert 'InstanceNorm2dPlus_0.beta' in names
