"""Explicit incompressible Navier–Stokes stepper on (B, H, W) fields.

Counterpart of the JAX package's ``ops/ns_step.py`` (the plain functions,
same names) and of the TPU kernel ``ops/ns_step_pallas.py``
``ns_step_fused`` (kernel K4).  On the card, :func:`ns_step_plan` picks one
of two kernels from the image's shape alone:

- ``'smem'`` (``csrc/ns_step.cu``): one launch, the image's working set in
  shared memory (every image whose fields fit in one block's 227 KB: 64x64,
  the UKF's size, and somewhat larger), one block per image, or a cluster
  of up to 8 sharing its rows where the batch is too small to fill the
  card;
- ``'staged'`` (``csrc/ns_step_staged.cu``): three launches through L2,
  for larger images.

Semantics as in the JAX package: central differences, one-sided at the
edges; CIP advection with the upwind neighbour picked by the sign of the
velocity, where ``u >= 0`` counts as positive (sign(0) = +1); reflect
boundaries; one step is velocity, then pressure, then density.

:func:`ns_step_fused` takes the plain version, :func:`ns_step`, only for
tensors on the CPU; for CUDA tensors it launches a kernel or raises.
``ns_step_fused.launches`` counts its calls, ``launches_by_kernel`` each
kernel's.  Forward only: the backward comes with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from b_pinn_kalman_filter_tpu_torch.ops import _build

Tensor = torch.Tensor
_SIGNATURES = {
    'ns_step_f32': (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 3
                   + (ctypes.c_float,) * 4 + (ctypes.c_int,) * 3
                   + (ctypes.c_void_p,),
}
_STAGED_SIGNATURES = {
    'ns_step_staged_f32': (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 3
                          + (ctypes.c_float,) * 4 + (ctypes.c_void_p,),
}
# csrc/ns_step.cu keeps ten f32 fields of an image in shared memory (p,
# dens, u_n, v_n, four gradients, u2, v2), within the H100's 227 KB a block,
# an image's rows shared by a cluster of at most 8 blocks; a launch aims at
# one wave of the H100's 132 SMs.
SMEM_FIELDS = 10
SMEM_LIMIT = 232448
MAX_CLUSTER = 8
NUM_SMS = 132
THREADS = 1024   # a block an image (512 a block of a cluster)


def _sshift_x(f: Tensor, s: int) -> Tensor:
  """f[..., y, x + s] for s = +-1, reflect boundary."""
  if s == -1:   # value at x-1; x=0 reflects to 1
    return torch.cat([f[..., :, 1:2], f[..., :, :-1]], dim=-1)
  return torch.cat([f[..., :, 1:], f[..., :, -2:-1]], dim=-1)


def _sshift_y(f: Tensor, s: int) -> Tensor:
  """f[..., y + s, x] for s = +-1, reflect boundary."""
  if s == -1:
    return torch.cat([f[..., 1:2, :], f[..., :-1, :]], dim=-2)
  return torch.cat([f[..., 1:, :], f[..., -2:-1, :]], dim=-2)


def gradient(field: Tensor, dx: float) -> Tuple[Tensor, Tensor]:
  """(df/dx, df/dy): central differences, one-sided at the edges."""
  H, W = field.shape[-2], field.shape[-1]
  col = torch.arange(W, device=field.device)
  row = torch.arange(H, device=field.device)[:, None]

  fxp = _sshift_x(field, 1)
  fxm = _sshift_x(field, -1)
  central_x = (fxp - fxm) / dx / 2
  left = (fxp - field) / dx
  right = (field - fxm) / dx
  df_dx = torch.where(col == 0, left,
                      torch.where(col == W - 1, right, central_x))

  fyp = _sshift_y(field, 1)
  fym = _sshift_y(field, -1)
  central_y = (fyp - fym) / dx / 2
  bottom = (fyp - field) / dx
  top = (field - fym) / dx
  df_dy = torch.where(row == 0, bottom,
                      torch.where(row == H - 1, top, central_y))
  return df_dx, df_dy


def cip_advect(dens: Tensor, dens_dx: Tensor, dens_dy: Tensor, u: Tensor,
               v: Tensor, dt: float, dx: float) -> Tensor:
  """CIP advection of ``dens`` by (u, v); the upwind neighbour is
  (x - sign(u), y - sign(v)) with sign(0) = +1."""
  xp = u >= 0.0
  yp = v >= 0.0
  x_sf = torch.where(xp, 1.0, -1.0).to(dens.dtype)
  y_sf = torch.where(yp, 1.0, -1.0).to(dens.dtype)

  def sel_x(f):
    return torch.where(xp, _sshift_x(f, -1), _sshift_x(f, 1))

  def sel_y(f):
    return torch.where(yp, _sshift_y(f, -1), _sshift_y(f, 1))

  d_xm = sel_x(dens)
  d_ym = sel_y(dens)
  d_mm = _sshift_y(_sshift_x(dens, -1), -1)
  d_mp = _sshift_y(_sshift_x(dens, -1), 1)
  d_pm = _sshift_y(_sshift_x(dens, 1), -1)
  d_pp = _sshift_y(_sshift_x(dens, 1), 1)
  d_xym = torch.where(xp, torch.where(yp, d_mm, d_mp),
                      torch.where(yp, d_pm, d_pp))
  dx_xm = sel_x(dens_dx)
  dx_ym = sel_y(dens_dx)
  dy_xm = sel_x(dens_dy)
  dy_ym = sel_y(dens_dy)

  tmp1 = dens - d_ym - d_xm + d_xym
  tmp2 = d_xm - dens
  tmp3 = d_ym - dens

  x_den = x_sf * dx ** 3
  y_den = y_sf * dx ** 3

  a = (x_sf * (dx_xm + dens_dx) * dx - 2.0 * (-tmp2)) / x_den
  b = (y_sf * (dy_ym + dens_dy) * dx - 2.0 * (-tmp3)) / y_den
  c = (-tmp1 - x_sf * (dx_ym - dens_dx) * dx) / y_den
  d = (-tmp1 - y_sf * (dy_xm - dens_dy) * dx) / x_den
  e = (3.0 * tmp2 + x_sf * (dx_xm + 2.0 * dens_dx) * dx) / dx / dx
  f = (3.0 * tmp3 + y_sf * (dy_ym + 2.0 * dens_dy) * dx) / dx / dx
  g = (-(dy_xm - dens_dy) + c * dx * dx) / (x_sf * dx)

  X = -u * dt
  Y = -v * dt
  return (((a * X + c * Y + e) * X + g * Y + dens_dx) * X
          + ((b * Y + d * X + f) * Y + dens_dy) * Y
          + dens)


def update_density(dens: Tensor, u: Tensor, v: Tensor, dt: float,
                   dx: float) -> Tensor:
  """Density step: CIP advection by (u, v)."""
  dens_dx, dens_dy = gradient(dens, dx)
  return cip_advect(dens, dens_dx, dens_dy, u, v, dt, dx)


def update_velocity(u: Tensor, v: Tensor, pres: Tensor, dt: float,
                    dx: float) -> Tuple[Tensor, Tensor]:
  """Pressure-gradient update, then CIP self-advection of u and v by the
  updated field."""
  dp_dx, dp_dy = gradient(pres, dx)
  u_n = u - dp_dx * dt
  v_n = v - dp_dy * dt

  du_dx, du_dy = gradient(u_n, dx)
  u_out = cip_advect(u_n, du_dx, du_dy, u_n, v_n, dt, dx)

  dv_dx, dv_dy = gradient(v_n, dx)
  v_out = cip_advect(v_n, dv_dx, dv_dy, u_n, v_n, dt, dx)
  return u_out, v_out


def update_pressure(u: Tensor, v: Tensor, pres: Tensor, dt: float,
                    dx: float) -> Tensor:
  """Pressure relaxation: neighbour average plus the divergence and strain
  terms."""
  p_xm = _sshift_x(pres, -1)
  p_xp = _sshift_x(pres, 1)
  p_ym = _sshift_y(pres, -1)
  p_yp = _sshift_y(pres, 1)
  aver_p = 0.25 * (p_xm + p_xp + p_ym + p_yp)

  u_xx = _sshift_x(u, 1) - _sshift_x(u, -1)
  v_xx = _sshift_x(v, 1) - _sshift_x(v, -1)
  u_yy = _sshift_y(u, 1) - _sshift_y(u, -1)
  v_yy = _sshift_y(v, 1) - _sshift_y(v, -1)

  return (aver_p
          + (u_xx * u_xx + v_yy * v_yy + u_yy * v_xx) / 8.0
          - dx * (u_xx + v_yy) / (8 * dt))


def ns_step(dens: Tensor, u: Tensor, v: Tensor, pres: Tensor, dt: float,
            dx: float) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
  """One NS step, the plain version: velocity, then pressure, then
  density.  Returns (dens, u, v, pres)."""
  u, v = update_velocity(u, v, pres, dt, dx)
  pres = update_pressure(u, v, pres, dt, dx)
  dens = update_density(dens, u, v, dt, dx)
  return dens, u, v, pres


def ns_step_plan(B: int, H: int, W: int) -> Dict:
  """How a (B, H, W) step runs on the card.  ``kernel``: ``'smem'`` (one
  launch) where an image's ten fields fit in one block's shared memory,
  else ``'staged'``.  ``cluster``: blocks that share an image's rows,
  doubled up to 8 while they divide H and B * cluster blocks stay within
  one wave of the card.  ``smem_bytes``: a block's fields.  ``vec``:
  16-byte loads and stores, for a block an image of a multiple of 4 floats,
  at least 4 for each of its threads."""
  image = SMEM_FIELDS * H * W * 4
  if image > SMEM_LIMIT:
    return dict(kernel='staged', cluster=1, smem_bytes=image, vec=0)
  cluster = 1
  while (cluster < MAX_CLUSTER and H % (2 * cluster) == 0
         and B * 2 * cluster <= NUM_SMS):
    cluster *= 2
  pixels = H * W
  return dict(kernel='smem', cluster=cluster, smem_bytes=image // cluster,
              vec=int(cluster == 1 and pixels % 4 == 0
                      and pixels >= 4 * THREADS))


def ns_step_fused(dens: Tensor, u: Tensor, v: Tensor, p: Tensor, dt: float,
                  dx: float) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
  """One NS step on (B, H, W) f32 fields (kernel K4 on the card): one
  launch per call, the kernel of :func:`ns_step_plan`."""
  fields = (dens, u, v, p)
  _build.forward_only('ns_step_fused', *fields)
  if dens.device.type == 'cpu':
    return ns_step(dens, u, v, p, dt, dx)
  if dens.device.type != 'cuda':
    raise ValueError(f'ns_step_fused: no kernel for device {dens.device}')
  _check(fields)
  B, H, W = dens.shape
  plan = ns_step_plan(B, H, W)
  if plan['kernel'] == 'staged':
    outs = _staged(fields, dt, dx)
  else:
    ins = [_build.aligned(t) for t in fields]
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    lib = _build.load('ns_step', _SIGNATURES)
    stream = torch.cuda.current_stream(dens.device).cuda_stream
    err = lib.ns_step_f32(*[t.data_ptr() for t in ins + outs], B, H, W, dt,
                          dx, dx ** 3, 8 * dt, plan['cluster'], plan['vec'],
                          plan['smem_bytes'], stream)
    _build.check_launch(err, 'ns_step_fused')
  ns_step_fused.launches += 1
  ns_step_fused.launches_by_kernel[plan['kernel']] += 1
  return tuple(outs)


def _check(fields) -> None:
  dens = fields[0]
  if dens.ndim != 3 or any(t.shape != dens.shape for t in fields):
    raise ValueError('ns_step_fused: fields must share one (B, H, W) shape, '
                     f'got {[tuple(t.shape) for t in fields]}')
  if any(t.dtype != torch.float32 for t in fields):
    raise TypeError('ns_step_fused: the kernel takes float32 fields')
  if any(t.device != dens.device for t in fields):
    raise ValueError('ns_step_fused: fields must share a device')
  B, H, W = dens.shape
  if H < 2 or W < 2:
    raise ValueError(f'ns_step_fused: H and W must be >= 2, got {H}x{W}')
  if dens.numel() >= 2 ** 31:
    raise ValueError('ns_step_fused: fields too large for 32-bit indexing')


def _staged(fields, dt: float, dx: float) -> list:
  ins = [t.contiguous() for t in fields]
  outs = [torch.empty_like(ins[0]) for _ in range(4)]
  scratch = [torch.empty_like(ins[0]) for _ in range(2)]   # u_n, v_n
  B, H, W = ins[0].shape
  lib = _build.load('ns_step_staged', _STAGED_SIGNATURES)
  stream = torch.cuda.current_stream(ins[0].device).cuda_stream
  err = lib.ns_step_staged_f32(*[t.data_ptr() for t in ins + outs + scratch],
                               B, H, W, dt, dx, dx ** 3, 8 * dt, stream)
  _build.check_launch(err, 'ns_step_fused (staged)')
  return outs


def _ns_step_staged(dens: Tensor, u: Tensor, v: Tensor, p: Tensor,
                    dt: float, dx: float) -> Tuple[Tensor, ...]:
  """The staged kernel on CUDA fields of any size, whatever
  :func:`ns_step_plan` would pick: the yardstick ``chip_smoke.py`` times
  beside the one-launch kernel.  Not counted in ``launches``."""
  fields = (dens, u, v, p)
  _check(fields)
  return tuple(_staged(fields, dt, dx))


ns_step_fused.launches = 0
ns_step_fused.launches_by_kernel = {'smem': 0, 'staged': 0}
