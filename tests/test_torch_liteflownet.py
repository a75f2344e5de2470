"""The port's LiteFlowNet against flax (f32, CPU): the whole cascade's
flows and the gradients of a seeded linear functional of them, with
respect to every parameter and both frames, against ONE jitted JAX
``value_and_grad`` at 1x64x64 (the smallest size whose level 6 is 2x2),
the only JAX program through the LiteFlowNet in tier-1.  The JAX tree is
shape-traced and randomised (``tests/port_parity.py``), never
initialised.  Limit: 1e-4 relative to max |JAX| per tree.  The file
holds this one test, so that xdist's ``loadfile`` hands it out among
the last files (its pieces: tests/test_torch_liteflownet_parts.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from b_pinn_kalman_filter_tpu import configs as jax_configs
from b_pinn_kalman_filter_tpu.models import liteflownet as jax_lfn
from b_pinn_kalman_filter_tpu_torch import configs
from b_pinn_kalman_filter_tpu_torch.models import liteflownet
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax
from tests import port_parity
from tests.port_parity import compare_trees
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
SIZE = 64


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want):
  want = np.asarray(want)
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  assert got.shape == want.shape, (got.shape, want.shape)
  return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _nest(flat):
  tree = {}
  for name, value in flat.items():
    node = tree
    *parents, leaf = name.split('.')
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = value
  return tree


def test_cascade_and_gradients_match_jax():
  """Every flow of the cascade (levels 6 to 2, then full size) and the
  gradients of sum_i <w_i, flow_i> (w_i seeded normals) for every
  parameter and both frames; the port's parameter names are the flax
  paths."""
  config = jax_configs.get_config('pinn/pinn_pde_lfn')
  model = jax_lfn.LiteFlowNet(config)
  frame = jnp.zeros((1, SIZE, SIZE, 1))
  shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), frame,
                                             frame))['params']
  params = port_parity.randomized_params(shapes, seed=1)
  rng = np.random.default_rng(2)
  f1, f2 = rng.random((2, 1, SIZE, SIZE, 1)).astype(np.float32)
  sizes = [SIZE >> s for s in (5, 4, 3, 2, 1, 0)]
  weights = [rng.standard_normal((1, s, s, 2)).astype(np.float32)
             for s in sizes]

  def functional(p, a, b):
    flows = model.apply({'params': p}, a, b)
    return sum(jnp.sum(f * w) for f, w in zip(flows, weights)), flows

  (j_value, j_flows), (j_gp, j_g1, j_g2) = jax.jit(
      jax.value_and_grad(functional, argnums=(0, 1, 2), has_aux=True),
      compiler_options=port_parity.FAST_COMPILE)(params, f1, f2)

  port = liteflownet.LiteFlowNet(configs.get_config('pinn/pinn_pde_lfn'),
                                 kernels=False)
  params_from_jax(params, port)
  named = dict(port.named_parameters())
  a, b = _t(f1).requires_grad_(), _t(f2).requires_grad_()
  flows = port(a, b)
  value = sum(torch.sum(f * _t(w)) for f, w in zip(flows, weights))
  grads = torch.autograd.grad(value, list(named.values()) + [a, b])

  assert len(flows) == len(j_flows) == 6
  for got, want in zip(flows, j_flows):
    assert np.abs(np.asarray(want)).max() > 1e-3    # randomised weights
    assert _rel(got, want) <= TOL
  assert _rel(value, j_value) <= TOL
  compare_trees(_nest({n: g.numpy() for n, g in zip(named, grads)}), j_gp,
                TOL, 'parameter gradients')
  compare_trees({'f1': grads[-2].numpy(), 'f2': grads[-1].numpy()},
                {'f1': j_g1, 'f2': j_g2}, TOL, 'frame gradients')
