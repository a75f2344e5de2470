"""The Navier–Stokes residual of PINN phase 2, the port's ``pinn.equation_mse``
against the JAX package's (f32, CPU): on the Taylor–Green field at 1x1
grids, where the sum-then-grad partials are exact; on a two-conv mini net
written in both frameworks with shared numpy weights, value and weight
gradient; on the tiny PINN (one FlowNet level (4,), 8x8, batch 2) with
the same randomised parameters; and the port's parameter gradient of that
residual in float64 against central differences.

Re is a traced argument of each jitted JAX function, so each compiles
once and runs at Re = 1 (the viscous terms count) and Re = 1e7 (phase 2's
value).  Coordinates: the unit grid, and the unit grid jittered by up to
0.01 (tests/test_pinn_residual_parity.py), which has neither pixel where
the spatial embedding's sqrt(x^2 + y^2 + 1e-12) or its mirror puts a
second derivative of 1e6.

Limits: 1e-4 relative to max |JAX| (tests/port_parity.py); 1e-5 relative
for the float64 central differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from b_pinn_kalman_filter_tpu.pinn import pinn as jax_pinn
from b_pinn_kalman_filter_tpu_torch.models.convert import params_from_jax
from b_pinn_kalman_filter_tpu_torch.pinn import pinn
from tests import port_parity
from tests.port_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
FD_TOL = 1e-5
RES = (1.0, 1e7)
TG_RE = 100.0     # the Taylor–Green field's own Reynolds number
BATCH, SIZE = 2, 8
TINY = {('data', 'image_size'): SIZE,
        ('model', 'feature_nums'): (4,),
        ('training', 'batch_size'): BATCH}


def _rel(got, want):
  return port_parity._rel(np.asarray(got), np.asarray(want))


def _coords(jitter, seed=0, batch=BATCH, size=SIZE):
  """x, y (B, S, S, 1) float32: the unit grid, plus ``jitter`` times a
  uniform draw."""
  rng = np.random.default_rng(seed)
  grid = np.linspace(0, 1, size, dtype=np.float32)
  x = np.broadcast_to(grid[None, None, :, None], (batch, size, size, 1))
  y = np.broadcast_to(grid[None, :, None, None], (batch, size, size, 1))
  return tuple((c + jitter * rng.random(c.shape)).astype(np.float32)
               for c in (x, y))


COORDS = {'unit': 0.0, 'jittered': 0.01}


# -- Taylor–Green ------------------------------------------------------------

def _taylor_green(xp):
  """(u, v, p) of the decaying Taylor–Green vortex at ``TG_RE``, in the
  array module ``xp`` (jnp or torch)."""
  nu = 1.0 / TG_RE

  def apply_uvp(x, y, t):
    decay = xp.exp(-2 * nu * t[:, None, None, None])
    u = xp.cos(x) * xp.sin(y) * decay
    v = -xp.sin(x) * xp.cos(y) * decay
    p = -0.25 * (xp.cos(2 * x) + xp.cos(2 * y)) * decay ** 2
    return u, v, p

  return apply_uvp


def _wrong_field(x, y, t):
  """u = x^2, v = y^2, p = 0: u reaches neither y nor t, v neither x
  nor t, p nothing (their partials are zeros, as jax.grad gives them)."""
  return x ** 2, y ** 2, x * 0


@pytest.fixture(scope='module')
def taylor_green():
  rng = np.random.default_rng(0)
  x, y = rng.uniform(0, 2 * np.pi, (2, 16, 1, 1, 1)).astype(np.float32)
  t = rng.uniform(0, 0.5, (16,)).astype(np.float32)
  fields = {'taylor_green': (_taylor_green(jnp), _taylor_green(torch)),
            'wrong_field': (_wrong_field, _wrong_field)}
  jitted = {name: jax.jit(lambda x, y, t, Re, fn=pair[0]:
                          jax_pinn.equation_mse(fn, x, y, t, Re))
            for name, pair in fields.items()}
  return (x, y, t), fields, jitted


@pytest.mark.parametrize('field', ['taylor_green', 'wrong_field'])
@pytest.mark.parametrize('Re', RES)
def test_analytic_fields_match_jax(taylor_green, field, Re):
  (x, y, t), fields, jitted = taylor_green
  want = jitted[field](x, y, t, Re)
  got = pinn.equation_mse(fields[field][1], *map(torch.from_numpy, (x, y, t)),
                          Re)
  assert _rel(got.detach(), want) <= TOL
  assert float(want) > 1e-5      # off the field's own Re: not zero


def test_taylor_green_residual_vanishes_at_its_own_re(taylor_green):
  (x, y, t), fields, jitted = taylor_green
  got = pinn.equation_mse(fields['taylor_green'][1],
                          *map(torch.from_numpy, (x, y, t)), TG_RE)
  assert float(got.detach()) < 1e-6
  assert float(jitted['taylor_green'](x, y, t, TG_RE)) < 1e-6


# -- the two-conv mini net ---------------------------------------------------

def _mini_jax(k1, k2):
  def apply_uvp(x, y, t):
    tb = jnp.broadcast_to(t[:, None, None, None], x.shape)
    h = jnp.concatenate([x, y, tb * x], axis=-1)
    dims = ('NHWC', 'HWIO', 'NHWC')
    h = jnp.tanh(jax.lax.conv_general_dilated(h, k1, (1, 1), 'SAME',
                                              dimension_numbers=dims))
    h = jax.lax.conv_general_dilated(h, k2, (1, 1), 'SAME',
                                     dimension_numbers=dims)
    return h[..., 0:1], h[..., 1:2], h[..., 2:3]
  return apply_uvp


def _mini_torch(k1, k2):
  def conv(h, k):
    return F.conv2d(h.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)

  def apply_uvp(x, y, t):
    tb = t[:, None, None, None].expand(x.shape)
    h = torch.tanh(conv(torch.cat([x, y, tb * x], dim=-1), k1))
    h = conv(h, k2)
    return h[..., 0:1], h[..., 1:2], h[..., 2:3]
  return apply_uvp


@pytest.fixture(scope='module')
def mini_net():
  rng = np.random.default_rng(1)
  k1 = (0.2 * rng.standard_normal((3, 3, 3, 8))).astype(np.float32)
  k2 = (0.2 * rng.standard_normal((3, 3, 8, 3))).astype(np.float32)
  x, y = _coords(0.01, seed=2)
  t = rng.random(BATCH).astype(np.float32)
  value_and_grad = jax.jit(jax.value_and_grad(
      lambda k1, k2, x, y, t, Re: jax_pinn.equation_mse(
          _mini_jax(k1, k2), x, y, t, Re), argnums=(0, 1)))
  return (k1, k2, x, y, t), value_and_grad


@pytest.mark.parametrize('Re', RES)
def test_mini_net_value_and_weight_gradient_match_jax(mini_net, Re):
  (k1, k2, x, y, t), value_and_grad = mini_net
  want, want_grads = value_and_grad(k1, k2, x, y, t, Re)
  weights = [torch.from_numpy(k).requires_grad_() for k in (k1, k2)]
  got = pinn.equation_mse(_mini_torch(*weights),
                          *map(torch.from_numpy, (x, y, t)), Re)
  grads = torch.autograd.grad(got, weights)
  assert _rel(got.detach(), want) <= TOL
  for g, w in zip(grads, want_grads):
    assert _rel(g, w) <= TOL


# -- the tiny PINN -----------------------------------------------------------

def _tiny_configs():
  from b_pinn_kalman_filter_tpu import configs as jax_configs
  from b_pinn_kalman_filter_tpu_torch import configs as torch_configs
  out = []
  for mod in (jax_configs, torch_configs):
    config = mod.get_config('pinn/pinn_pde')
    for (block, key), value in TINY.items():
      setattr(getattr(config, block), key, value)
    out.append(config)
  return tuple(out)


@pytest.fixture(scope='module')
def tiny_pinn():
  """The JAX residual of the tiny PINN (jitted once, Re traced), its
  randomised parameters, the port's PINN under them, and the frames."""
  jax_config, torch_config = _tiny_configs()
  model = port_parity.jax_pinn(jax_config)
  params = port_parity.randomized_params(
      port_parity.pinn_param_shapes(jax_config), seed=5)
  residual = jax.jit(
      lambda p, f1, f2, x, y, t, Re: jax_pinn.equation_mse_from_outputs(
          model, p, f1, f2, x, y, t, Re),
      compiler_options=port_parity.FAST_COMPILE)
  port = pinn.PINN(torch_config).eval()
  params_from_jax(params, port)
  f1, f2, _, _, t = port_parity.pinn_inputs(BATCH, SIZE, seed=6)
  return residual, params, port, (f1, f2, t)


@pytest.mark.parametrize('coords', list(COORDS))
@pytest.mark.parametrize('Re', RES)
def test_tiny_pinn_residual_matches_jax(tiny_pinn, coords, Re):
  residual, params, port, (f1, f2, t) = tiny_pinn
  x, y = _coords(COORDS[coords], seed=7)
  want = residual(params, f1, f2, x, y, t, Re)
  got = pinn.equation_mse_from_outputs(
      port, None, *map(torch.from_numpy, (f1, f2, x, y, t)), Re,
      create_graph=False)
  assert np.isfinite(float(want)) and float(want) > 0
  assert _rel(got, want) <= TOL


def test_tiny_pinn_parameter_gradient_matches_central_differences(
    tiny_pinn):
  """In float64 at Re = 1 on the jittered grid: the parameter gradient
  (a third derivative of the net) along three seeded unit directions
  against ``(R(p + h d) - R(p - h d)) / 2h``.

  The PressureNet reads the flow detached (JAX's ``stop_gradient``), so
  the gradient is that of the residual with the PressureNet's flow input
  held at its value under the unperturbed parameters: the differences
  are taken of that function (the full residual's differ from it)."""
  _, _, port, (f1, f2, t) = tiny_pinn
  model = pinn.PINN(port.config).double().eval()
  params = {k: v.detach().double() for k, v in port.named_parameters()}
  x, y = _coords(0.01, seed=8)
  f1, f2, x, y, t = (torch.from_numpy(a).double() for a in (f1, f2, x, y, t))

  def held(p):
    def apply_uvp(x_, y_, t_):
      flow = model.flow_only(f1, f2, x_, y_, t_, params=p)[-1]
      base = model.flow_only(f1, f2, x_, y_, t_, params=params)
      return (flow[..., 0:1], flow[..., 1:2],
              model.pressure_only(base, x_, y_, t_, params=p))
    return pinn.equation_mse(apply_uvp, x, y, t, 1.0, create_graph=False)

  leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
  # The biases last in the PressureNet shift p by a constant, which no
  # partial of p sees: zeros, as jax.grad gives them.
  grads = dict(zip(leaves, torch.autograd.grad(
      pinn.equation_mse_from_outputs(model, leaves, f1, f2, x, y, t, 1.0),
      list(leaves.values()), allow_unused=True, materialize_grads=True)))
  rng = np.random.default_rng(9)
  h = 1e-4
  for _ in range(3):
    d = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)))
         for k, v in params.items()}
    norm = float(torch.sqrt(sum((v ** 2).sum() for v in d.values())))
    want = float(sum((grads[k] * d[k]).sum() for k in d)) / norm
    plus, minus = (held({k: params[k] + s * h / norm * d[k] for k in params})
                   for s in (1, -1))
    got = float(plus - minus) / (2 * h)
    assert abs(got - want) <= FD_TOL * abs(want), (got, want)
