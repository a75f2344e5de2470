// One explicit Navier–Stokes step on (B, H, W) float32 fields.
//
// Replaces the TPU kernel `ns_step_fused`
// (b_pinn_kalman_filter_tpu/ops/ns_step_pallas.py:63, pallas_call :73,
// body `_ns_step_kernel` :34), which computes, per batch element:
//   1. u_n = u - dp/dx * dt, v_n = v - dp/dy * dt;
//   2. u2, v2 = CIP self-advection of u_n and v_n by (u_n, v_n);
//   3. p2 = pressure relaxation from p and (u2, v2);
//      d2 = CIP advection of dens by (u2, v2);
// with the stencils of b_pinn_kalman_filter_tpu/ops/ns_step.py: central
// differences, one-sided at the image edge (`gradient` :78), the upwind
// neighbour picked by u >= 0 and v >= 0, so sign(0) = +1 (`cip_advect`
// :123), and reflect boundaries (x = -1 reads x = 1, x = W reads W - 2).
//
// What bounds it on an H100: bytes.  About 320 operations per pixel against
// 4 fields read and 4 written (32 bytes), under the card's f32 balance
// point of 20 operations a byte; at the UKF's sigma-point batch
// (129 x 64 x 64) each field is 2.1 MB and the working set stays in the
// 50 MB L2.
//
// Design (simple and right first).  The stencils are chained: u2 at a pixel
// reads u_n two cells away (the gradient at the upwind neighbour), and u_n
// reads p one cell further; p2 and d2 read u2 one cell away.  A tile with a
// recomputed halo would have to apply the reflect boundary only where the
// halo meets the image edge, at every stage; instead the step runs as three
// launches that pass u_n, v_n and then u2, v2 through global memory (L2):
// each stage is one thread per pixel over the whole image, and every
// neighbour is read with the reflect rule of the image edge.  Gradients at
// neighbouring cells are recomputed from the field where they are needed,
// so no gradient field is stored.  Tiles are 32 x 8 pixels; the batch runs
// on blockIdx.z (looped past 65535), so B has no cap.  The arithmetic is
// written in the order of the reference expressions, divisions included
// (the CIP coefficients divide by sign * dx^3 with dx = 1/200 and cancel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int MAX_GRID_Z = 65535;

struct Consts {
  float dt, dx, dx3, dt8;   // dt, dx, dx^3 and 8 * dt, each rounded to f32
};

// Index i in [-1, n] reflected into [0, n - 1].
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i > n - 1 ? 2 * n - 2 - i : i);
}

// df/dx and df/dy at (y, x): central, one-sided at the image edge.
__device__ __forceinline__ float grad_x(const float* f, int y, int x, int W,
                                        float dx) {
  const float* row = f + int64_t(y) * W;
  if (x == 0) return (row[1] - row[0]) / dx;
  if (x == W - 1) return (row[W - 1] - row[W - 2]) / dx;
  return (row[x + 1] - row[x - 1]) / dx / 2.f;
}

__device__ __forceinline__ float grad_y(const float* f, int y, int x, int H,
                                        int W, float dx) {
  if (y == 0) return (f[int64_t(1) * W + x] - f[x]) / dx;
  if (y == H - 1) {
    return (f[int64_t(H - 1) * W + x] - f[int64_t(H - 2) * W + x]) / dx;
  }
  return (f[int64_t(y + 1) * W + x] - f[int64_t(y - 1) * W + x]) / dx / 2.f;
}

// CIP advection of the field f (one image) at (y, x) by the velocity (uc,
// vc) of that cell.
__device__ float cip(const float* f, int y, int x, int H, int W, float uc,
                     float vc, const Consts& k) {
  const bool xp = uc >= 0.f;
  const bool yp = vc >= 0.f;
  const float x_sf = xp ? 1.f : -1.f;
  const float y_sf = yp ? 1.f : -1.f;
  const int xm = reflect(xp ? x - 1 : x + 1, W);   // upwind column
  const int ym = reflect(yp ? y - 1 : y + 1, H);   // upwind row
  const float dx = k.dx;

  const float dens = f[int64_t(y) * W + x];
  const float d_xm = f[int64_t(y) * W + xm];
  const float d_ym = f[int64_t(ym) * W + x];
  const float d_xym = f[int64_t(ym) * W + xm];
  const float dens_dx = grad_x(f, y, x, W, dx);
  const float dens_dy = grad_y(f, y, x, H, W, dx);
  const float dx_xm = grad_x(f, y, xm, W, dx);
  const float dx_ym = grad_x(f, ym, x, W, dx);
  const float dy_xm = grad_y(f, y, xm, H, W, dx);
  const float dy_ym = grad_y(f, ym, x, H, W, dx);

  const float tmp1 = dens - d_ym - d_xm + d_xym;
  const float tmp2 = d_xm - dens;
  const float tmp3 = d_ym - dens;
  const float x_den = x_sf * k.dx3;
  const float y_den = y_sf * k.dx3;

  const float a = (x_sf * (dx_xm + dens_dx) * dx - 2.f * (-tmp2)) / x_den;
  const float b = (y_sf * (dy_ym + dens_dy) * dx - 2.f * (-tmp3)) / y_den;
  const float c = (-tmp1 - x_sf * (dx_ym - dens_dx) * dx) / y_den;
  const float d = (-tmp1 - y_sf * (dy_xm - dens_dy) * dx) / x_den;
  const float e = (3.f * tmp2 + x_sf * (dx_xm + 2.f * dens_dx) * dx) / dx / dx;
  const float f_ = (3.f * tmp3 + y_sf * (dy_ym + 2.f * dens_dy) * dx) / dx / dx;
  const float g = (-(dy_xm - dens_dy) + c * dx * dx) / (x_sf * dx);

  const float X = -uc * k.dt;
  const float Y = -vc * k.dt;
  return (((a * X + c * Y + e) * X + g * Y + dens_dx) * X
          + ((b * Y + d * X + f_) * Y + dens_dy) * Y
          + dens);
}

// Stage 1: the pressure-gradient velocity update.
__global__ void __launch_bounds__(TX * TY) velocity_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ p, float* __restrict__ u_n,
    float* __restrict__ v_n, int B, int H, int W, Consts k) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  for (int bi = blockIdx.z; bi < B; bi += gridDim.z) {
    const int64_t base = int64_t(bi) * H * W;
    const int64_t i = base + int64_t(y) * W + x;
    u_n[i] = u[i] - grad_x(p + base, y, x, W, k.dx) * k.dt;
    v_n[i] = v[i] - grad_y(p + base, y, x, H, W, k.dx) * k.dt;
  }
}

// Stage 2: CIP self-advection of u_n and v_n by (u_n, v_n).
__global__ void __launch_bounds__(TX * TY) advect_velocity_kernel(
    const float* __restrict__ u_n, const float* __restrict__ v_n,
    float* __restrict__ u2, float* __restrict__ v2, int B, int H, int W,
    Consts k) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  for (int bi = blockIdx.z; bi < B; bi += gridDim.z) {
    const int64_t base = int64_t(bi) * H * W;
    const int64_t i = base + int64_t(y) * W + x;
    const float uc = u_n[i];
    const float vc = v_n[i];
    u2[i] = cip(u_n + base, y, x, H, W, uc, vc, k);
    v2[i] = cip(v_n + base, y, x, H, W, uc, vc, k);
  }
}

// Stage 3: pressure relaxation and density advection by (u2, v2).
__global__ void __launch_bounds__(TX * TY) pressure_density_kernel(
    const float* __restrict__ dens, const float* __restrict__ p,
    const float* __restrict__ u2, const float* __restrict__ v2,
    float* __restrict__ dens_out, float* __restrict__ p_out, int B, int H,
    int W, Consts k) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int xl = reflect(x - 1, W);
  const int xr = reflect(x + 1, W);
  const int yl = reflect(y - 1, H);
  const int yr = reflect(y + 1, H);
  for (int bi = blockIdx.z; bi < B; bi += gridDim.z) {
    const int64_t base = int64_t(bi) * H * W;
    const int64_t row = base + int64_t(y) * W;
    const int64_t i = row + x;
    const int64_t up = base + int64_t(yl) * W + x;
    const int64_t down = base + int64_t(yr) * W + x;
    const float aver_p = 0.25f * (p[row + xl] + p[row + xr] + p[up] + p[down]);
    const float u_xx = u2[row + xr] - u2[row + xl];
    const float v_xx = v2[row + xr] - v2[row + xl];
    const float u_yy = u2[down] - u2[up];
    const float v_yy = v2[down] - v2[up];
    p_out[i] = aver_p + (u_xx * u_xx + v_yy * v_yy + u_yy * v_xx) / 8.f
               - k.dx * (u_xx + v_yy) / k.dt8;
    dens_out[i] = cip(dens + base, y, x, H, W, u2[i], v2[i], k);
  }
}

}  // namespace

// All fields (B, H, W) float32, contiguous; u_n and v_n are scratch of the
// same shape.  H and W must be >= 2.  dx3 = dx^3 and dt8 = 8 * dt, as the
// reference rounds them.  Returns the first nonzero cudaGetLastError()
// after the three launches (0 on success).
extern "C" int ns_step_f32(const void* dens, const void* u, const void* v,
                           const void* p, void* dens_out, void* u_out,
                           void* v_out, void* p_out, void* u_n, void* v_n,
                           int B, int H, int W, float dt, float dx, float dx3,
                           float dt8, void* stream) {
  if (B <= 0 || H < 2 || W < 2) return int(cudaErrorInvalidValue);
  const Consts k{dt, dx, dx3, dt8};
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY,
                  B < MAX_GRID_Z ? B : MAX_GRID_Z);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* un = static_cast<float*>(u_n);
  float* vn = static_cast<float*>(v_n);
  float* u2 = static_cast<float*>(u_out);
  float* v2 = static_cast<float*>(v_out);

  velocity_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(p), un, vn, B, H, W, k);
  int err = int(cudaGetLastError());
  if (err) return err;
  advect_velocity_kernel<<<grid, block, 0, s>>>(un, vn, u2, v2, B, H, W, k);
  err = int(cudaGetLastError());
  if (err) return err;
  pressure_density_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(dens), static_cast<const float*>(p), u2, v2,
      static_cast<float*>(dens_out), static_cast<float*>(p_out), B, H, W, k);
  return int(cudaGetLastError());
}
