"""The port's NCSN++ against the JAX package's with DDPM resblocks
(``resblock_type='ddpm'``: the separate ``Downsample`` / ``Upsample``
modules with their convs, the NIN shortcut, no rescaling), and with the
residual output pyramid (``progressive='residual'``), in f32 on the CPU
at ``TINY_NCSNPP``.  Two tests, one JAX program each (see
``test_torch_ncsnpp.py``).  Limit: 1e-4 of max |JAX|."""

from tests.port_parity import one_torch_thread  # noqa: F401
from tests.test_torch_ncsnpp import check_variant


def test_ncsnpp_with_ddpm_resblocks_matches_jax():
  model = check_variant('ddpm', seed=2)
  names = dict(model.named_parameters())
  assert 'Downsample_0.Conv_0.kernel' in names
  assert 'Upsample_0.Conv3x3_0.Conv_0.kernel' in names
  assert any(n.endswith('NIN_0.W') and n.startswith('ResnetBlockDDPMpp')
             for n in names)


def test_ncsnpp_with_the_residual_output_pyramid_matches_jax():
  model = check_variant('residual', seed=3)
  names = dict(model.named_parameters())
  assert 'Upsample_0.Conv2d_0.weight' in names
  assert 'Downsample_0.Conv2d_0.weight' in names
