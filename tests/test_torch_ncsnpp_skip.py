"""The port's NCSN++ against the JAX package's with the 256^2 configs'
pyramids, ``progressive='output_skip'`` and
``progressive_input='input_skip'``, combined by 'sum' (the configs') and
by 'cat' (which doubles the width after each downsampling), in f32 on the
CPU at ``TINY_NCSNPP``.  Two tests, one JAX program each (see
``test_torch_ncsnpp.py``).  Limit: 1e-4 of max |JAX|."""

import pytest

from tests.port_parity import one_torch_thread  # noqa: F401
from tests.test_torch_ncsnpp import check_variant


@pytest.mark.parametrize('variant', ['skip_sum', 'skip_cat'])
def test_ncsnpp_pyramids_match_jax(variant):
  model = check_variant(variant, seed=1)
  names = dict(model.named_parameters())
  # The output pyramid's plain GroupNorm and conv at each level; no final
  # GroupNorm and conv of its own.
  assert 'Combine_0.Conv1x1_0.Conv_0.kernel' in names
  assert sum(n.startswith('GroupNorm_') for n in names) == 2 * 2
