"""Each module of the port's ``models/layerspp.py`` against the JAX
package's ``models/layerspp.py`` at 8 and 128 channels, in f32 on the CPU:
every flax parameter randomised from a numpy seed and copied in by
``convert.params_from_jax`` (which refuses a leaf left over on either
side).  At 8 channels NCSN++'s ``max(min(C // 4, 32), 1)`` gives 2 groups
and the DDPM's ``min(32, C)`` 8, at 128 both give 32, so both branches of
the group count run.  Each case is one jitted JAX program of both widths.
Limit: 1e-4 of max |JAX|."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu.models import layerspp as jax_layerspp
from b_pinn_kalman_filter_tpu_torch.models import convert, layerspp
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
WIDTHS = (8, 128)
FIR = (1, 3, 3, 1)
TEMB = 16


def _case(name, width):
  """(flax module, port module, input shapes, uses temb)."""
  C, silu = width, jax.nn.silu
  j_pp, t_pp = jax_layerspp, layerspp
  if name == 'fourier':
    return (j_pp.GaussianFourierProjection(C, scale=16.),
            t_pp.GaussianFourierProjection(C, 16.), [(3,)], False)
  if name in ('combine_cat', 'combine_sum'):
    method = name.split('_')[1]
    return (j_pp.Combine(dim2=C, method=method),
            t_pp.Combine(3, C, method), [(2, 4, 4, 3), (2, 4, 4, C)], False)
  if name == 'attention':
    return (j_pp.AttnBlockpp(skip_rescale=True, init_scale=0.),
            t_pp.AttnBlockpp(C, skip_rescale=True), [(2, 4, 4, C)], False)
  if name.startswith(('up_', 'down_')):
    kind, fir, conv = name.split('_')
    fir, conv = fir == 'fir', conv == 'conv'
    j_cls, t_cls = ((j_pp.Upsample, t_pp.Upsample) if kind == 'up'
                    else (j_pp.Downsample, t_pp.Downsample))
    return (j_cls(out_ch=C // 2 if conv else None, with_conv=conv, fir=fir,
                  fir_kernel=FIR),
            t_cls(C, C // 2 if conv else None, with_conv=conv, fir=fir,
                  fir_kernel=FIR), [(2, 4, 4, C)], False)
  if name.startswith('ddpm'):
    shortcut = name == 'ddpm_conv_shortcut'
    return (j_pp.ResnetBlockDDPMpp(act=silu, out_ch=2 * C,
                                   conv_shortcut=shortcut, dropout=0.1,
                                   skip_rescale=True, init_scale=0.),
            t_pp.ResnetBlockDDPMpp(F.silu, C, 2 * C, TEMB,
                                   conv_shortcut=shortcut,
                                   skip_rescale=True),
            [(2, 4, 4, C), (2, TEMB)], True)
  kind = name.split('_')[1]
  fir = not name.endswith('naive')
  return (j_pp.ResnetBlockBigGANpp(act=silu, out_ch=C, up=kind == 'up',
                                   down=kind == 'down', fir=fir,
                                   fir_kernel=FIR, skip_rescale=False),
          t_pp.ResnetBlockBigGANpp(F.silu, C, C, TEMB, up=kind == 'up',
                                   down=kind == 'down', fir=fir,
                                   fir_kernel=FIR, skip_rescale=False),
          [(2, 4, 4, C), (2, TEMB)], True)


CASES = ['fourier', 'combine_cat', 'combine_sum', 'attention',
         'up_fir_conv', 'up_fir_plain', 'up_naive_conv', 'up_naive_plain',
         'down_fir_conv', 'down_fir_plain', 'down_naive_conv',
         'down_naive_plain', 'ddpm', 'ddpm_conv_shortcut', 'biggan_none',
         'biggan_up', 'biggan_down', 'biggan_up_naive']


@pytest.mark.parametrize('name', CASES)
def test_layerspp_module_matches_jax(name):
  cases = [_case(name, width) for width in WIDTHS]
  rng = np.random.default_rng(0)
  inputs, params = [], []
  for i, (ref, _, shapes, temb) in enumerate(cases):
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if name == 'fourier':
      xs = [np.abs(x) + 0.5 for x in xs]
    inputs.append(xs)
    kw = dict(train=False) if temb else {}
    tree = jax.eval_shape(functools.partial(ref.init, **kw),
                          jax.random.PRNGKey(0), *map(jnp.asarray, xs))
    params.append(port_parity.randomized_params(tree.get('params', {}),
                                                seed=i))

  def apply(params, inputs):
    return [ref.apply({'params': p}, *xs, **(dict(train=False) if temb
                                             else {}))
            for (ref, _, _, temb), p, xs in zip(cases, params, inputs)]

  wants = jax.jit(apply, compiler_options=port_parity.FAST_COMPILE)(
      params, [[jnp.asarray(x) for x in xs] for xs in inputs])
  for (_, port, _, temb), p, xs, want in zip(cases, params, inputs, wants):
    convert.params_from_jax(p, port)
    args = [torch.from_numpy(x) for x in xs]
    with torch.no_grad():
      got = port(*args, train=False) if temb else port(*args)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= TOL, (name, tuple(want.shape), err)


def test_norm_act_group_counts():
  assert [layerspp.num_groups(c) for c in (1, 3, 8, 64, 128, 512)] == [
      1, 1, 2, 16, 32, 32]
  site = layerspp.norm_act(8, F.silu, torch.float32)
  assert site.num_groups == 2 and site.kernels


def test_fourier_projection_has_a_zero_gradient():
  """``W`` is a parameter, outside the graph (JAX ``stop_gradient``)."""
  module = layerspp.GaussianFourierProjection(4, 16.)
  module.W.data.normal_()
  out = module(torch.tensor([0.3, 2.0], requires_grad=True))
  assert out.shape == (2, 8)
  (grad,) = torch.autograd.grad(out.sum(), [module.W], allow_unused=True,
                                materialize_grads=True)
  assert torch.equal(grad, torch.zeros(4))
