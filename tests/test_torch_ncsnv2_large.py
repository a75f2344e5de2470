"""The port's NCSNv2 for 96-128px (``ncsnv2_128``, at 96x96) and 129-256px
(``ncsnv2_256``, at 136x136) against the JAX package's, in f32 on the CPU
at nf 8, as ``test_torch_ncsnv2.py`` holds ``ncsnv2_64``; the file holds
two tests, one JAX forward each.  Limit: 1e-4 of max |JAX|."""

import pytest

from tests.port_parity import one_torch_thread  # noqa: F401
from tests.test_torch_ncsnv2 import check_forward


@pytest.mark.parametrize('name,size', [('ncsnv2_128', 96),
                                       ('ncsnv2_256', 136)])
def test_large_ncsnv2_matches_jax(name, size):
  model = check_forward(name, size)
  stages = 5 if name == 'ncsnv2_128' else 6
  assert hasattr(model, f'ResidualBlock_{2 * stages - 1}')
  assert hasattr(model, f'RefineBlock_{stages - 1}')
