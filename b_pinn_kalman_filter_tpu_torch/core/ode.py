"""ODE integrators: adaptive Dormand–Prince 5(4), fixed-grid RK4 and Euler.

Counterpart of the JAX package's ``core/ode.py``.  Where JAX integrates in
one ``lax.while_loop`` on the device, this is a loop on the host: the
right-hand side's kernels run on the tensors' device, and the step-size
control reads the error norm once a step (one synchronisation for six
evaluations).  The scalars of the controller (t, h, the factor) are numpy
scalars of the state's dtype, so they round as the JAX carry does: the
same tableau, error norm, clipping to ``t1``, ``1 + 6 * steps`` evaluations
and the ``done`` test with ``1e-12``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# Dormand-Prince 5(4) Butcher tableau.
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = [
    np.array([]),
    np.array([1 / 5]),
    np.array([3 / 40, 9 / 40]),
    np.array([44 / 45, -56 / 15, 32 / 9]),
    np.array([19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]),
    np.array([9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]),
    np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]),
]
_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                 -92097 / 339200, 187 / 2100, 1 / 40])

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ORDER_EXP = -1.0 / 5.0  # error estimator order 4 -> exponent -1/(4+1)


class ODEResult(NamedTuple):
  y: Tensor       # final state
  nfe: int        # number of right-hand-side evaluations
  status: int     # 0 = success, 1 = max_steps exhausted


def scalar_dtype(dtype: torch.dtype):
  """The numpy scalar type the controller computes in for a state of
  ``dtype`` (f64 for f64 states, else f32, as JAX's carry)."""
  return np.float64 if dtype == torch.float64 else np.float32


def _dp_step(fn: Callable, t, y: Tensor, h, k0: Tensor):
  """One Dormand–Prince step from (t, y) with step h and cached first stage
  k0.  Returns (y5, err_est, k_last), k_last = f at (t+h, y5) (FSAL)."""
  s = type(h)
  ks = [k0]
  for i in range(1, 7):
    ti = t + s(_C[i]) * h
    yi = y
    for j, aij in enumerate(_A[i]):
      yi = yi + float(h * s(aij)) * ks[j]
    ks.append(fn(ti, yi))
  y5 = y
  for i in range(7):
    if float(_B5[i]) != 0.0:
      y5 = y5 + float(h * s(_B5[i])) * ks[i]
  err = torch.zeros_like(y)
  for i in range(7):
    d = float(_B5[i] - _B4[i])
    if d != 0.0:
      err = err + float(h * s(d)) * ks[i]
  return y5, err, ks[6]


def odeint_dopri(fn: Callable[[object, Tensor], Tensor], y0: Tensor,
                 t0: float, t1: float, rtol: float = 1e-5,
                 atol: float = 1e-5, max_steps: int = 5000,
                 first_step: float = None) -> ODEResult:
  """Adaptive Dormand–Prince 5(4) integration of ``dy/dt = fn(t, y)`` from
  ``t0`` to ``t1`` (either direction); ``fn`` takes ``t`` as a numpy
  scalar.  scipy ``solve_ivp(method='RK45')``'s error norm (the RMS of
  ``err / (atol + rtol * max(|y|, |y_new|))``) and basic controller."""
  s = scalar_dtype(y0.dtype)
  t0, t1 = s(t0), s(t1)
  direction = s(np.sign(t1 - t0))
  span = s(abs(t1 - t0))
  h = (direction * span / s(100.0) if first_step is None
       else direction * s(first_step))
  done_at = span * s(1 - 1e-12)

  t, y = t0, y0
  k = fn(t0, y0)
  nfe = 1
  done = False
  steps = 0
  while steps < max_steps and not done:
    h = direction * min(abs(h), abs(t1 - t))
    y_new, err, k_new = _dp_step(fn, t, y, h, k)
    scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
    err_norm = s(torch.sqrt(torch.mean((err / scale) ** 2)).item())
    if err_norm == 0:
      factor = s(_MAX_FACTOR)
    else:
      factor = np.clip(s(_SAFETY) * err_norm ** s(_ORDER_EXP),
                       s(_MIN_FACTOR), s(_MAX_FACTOR))
    if err_norm <= 1:
      t, y, k = t + h, y_new, k_new
    h = h * factor
    nfe += 6
    done = bool(abs(t - t0) >= done_at)
    steps += 1
  return ODEResult(y=y, nfe=nfe, status=0 if done else 1)


def linspace(start: float, stop: float, num: int, dtype=np.float32
             ) -> np.ndarray:
  """``jnp.linspace(start, stop, num)`` by its formula, ``start * (1 -
  s) + stop * s`` with ``s = i / (num - 1)`` in ``dtype``, the last point
  ``stop``: grid points that key noise by their value then agree with
  JAX's (``np.linspace`` rounds some an ulp apart)."""
  start, stop = dtype(start), dtype(stop)
  if num == 1:
    return np.array([start], dtype)
  step = np.arange(num - 1, dtype=dtype) / dtype(num - 1)
  out = start * (dtype(1) - step) + stop * step
  return np.concatenate([out, np.array([stop], dtype)])


def odeint_rk4(fn: Callable[[object, Tensor], Tensor], y0: Tensor,
               t0: float, t1: float, n_steps: int) -> Tuple[Tensor, int]:
  """Fixed-grid classic RK4 (NFE = 4 * n_steps)."""
  ts = linspace(t0, t1, n_steps + 1, scalar_dtype(y0.dtype))
  two = type(ts[0])(2)
  y = y0
  for i in range(n_steps):
    t, h = ts[i], ts[i + 1] - ts[i]
    k1 = fn(t, y)
    k2 = fn(t + h / two, y + float(h / two) * k1)
    k3 = fn(t + h / two, y + float(h / two) * k2)
    k4 = fn(t + h, y + float(h) * k3)
    y = y + float(h / type(h)(6)) * (k1 + 2 * k2 + 2 * k3 + k4)
  return y, 4 * n_steps


def odeint_euler(fn: Callable[[object, Tensor], Tensor], y0: Tensor,
                 t0: float, t1: float, n_steps: int) -> Tuple[Tensor, int]:
  """Fixed-step Euler (NFE = n_steps)."""
  ts = linspace(t0, t1, n_steps + 1, scalar_dtype(y0.dtype))
  y = y0
  for i in range(n_steps):
    y = y + float(ts[i + 1] - ts[i]) * fn(ts[i], y)
  return y, n_steps
