// One explicit Navier–Stokes step on (B, H, W) float32 fields, one block
// per image, the image kept in shared memory.
//
// Replaces the TPU kernel `ns_step_fused`
// (b_pinn_kalman_filter_tpu/ops/ns_step_pallas.py:63, pallas_call :73,
// body `_ns_step_kernel` :34), which holds one batch element in VMEM and
// computes:
//   1. u_n = u - dp/dx * dt, v_n = v - dp/dy * dt;
//   2. u2, v2 = CIP self-advection of u_n and v_n by (u_n, v_n);
//   3. p2 = pressure relaxation from p and (u2, v2);
//   4. d2 = CIP advection of dens by (u2, v2);
// with the stencils of b_pinn_kalman_filter_tpu/ops/ns_step.py: central
// differences, one-sided at the image edge (`gradient` :78), the upwind
// neighbour picked by u >= 0 and v >= 0, so sign(0) = +1 (`cip_advect`
// :123), and reflect boundaries (x = -1 reads x = 1, x = W reads W - 2).
//
// What bounds it on an H100: bytes, 4 fields read and 4 written (32 bytes
// a pixel), against about 320 operations a pixel; but some 40 of those are
// IEEE divisions (the CIP coefficients divide by sign * dx^3 and cancel,
// so the reference's divisions are kept as written), each a short
// instruction sequence, so the rate of instructions is close behind.
//
// Design.  The stencils are chained (u2 reads u_n two cells away, u_n reads
// p one cell further), so a tile would need a halo grown by every stage,
// with the reflect rule applied where the halo meets the image edge.  A
// whole 64 x 64 image's working set fits in one SM's shared memory, so the
// image stays on chip and needs no halo at all:
// - one block holds one image; where the batch is too small to fill the
//   card (the rollout's single image), a cluster of up to 8 blocks shares
//   it, each holding a slice of rows, and reads the one row beyond its
//   slice that a stencil reaches from its neighbour through distributed
//   shared memory (ops/ns_step.py `ns_step_plan` picks the cluster);
// - p and dens come in with 16-byte loads (a block an image of a multiple
//   of 4 floats), u and v straight into registers in stage 1; every later
//   stage reads its neighbours from shared memory, with the reflect rule
//   and the one-sided edge gradients applied by index at the image edge
//   only;
// - the gradients of u_n, v_n and later dens are computed once a pixel into
//   shared memory (the staged kernel recomputes them at every neighbour
//   that reads them): ten fields of H * W floats, 160 KB at 64 x 64;
// - stages are separated by cluster barriers (a block barrier for a cluster
//   of one; five: after the loads, u_n/v_n, their gradients, u2/v2, and p2
//   with dens's gradients), and the four outputs are written once.
// The 129 sigma points of the UKF are 129 blocks: one wave on 132 SMs.
// Images whose ten fields do not fit in one block (ops/ns_step.py
// `ns_step_plan`) take the staged kernel, csrc/ns_step_staged.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;       // a block an image
constexpr int SPLIT_THREADS = 512;  // a block a slice of an image's rows
constexpr int FIELDS = 10;
constexpr int MAX_GRID = 65535;      // images on gridDim.y
constexpr int SMEM_LIMIT = 232448;   // the H100's 227 KB a block

struct Consts {
  float dt, dx, dx3, dt8;   // dt, dx, dx^3 and 8 * dt, each rounded to f32
};

// Index i in [-1, n] reflected into [0, n - 1].
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i > n - 1 ? 2 * n - 2 - i : i);
}

// An image's fields in shared memory, its rows split over the blocks of a
// cluster (SPLIT) or all in this block: this block holds rows [y_lo, y_lo +
// rows) of each field, field f at offset f * fs, and reads the row just
// above or below its slice from its neighbour's shared memory (the same
// layout there).  The stencils only ever reach one row past the slice,
// reflected rows included.
template <bool SPLIT>
struct Slab {
  float* here;
  const float* prev;     // the block above (rank - 1), if any
  const float* next;     // the block below (rank + 1), if any
  int y_lo, rows, W, fs;

  __device__ __forceinline__ const float* row(int f, int y) const {
    const int i = y - y_lo;
    if (SPLIT) {
      if (i < 0) return prev + f * fs + (i + rows) * W;
      if (i >= rows) return next + f * fs + (i - rows) * W;
    }
    return here + f * fs + i * W;
  }
  __device__ __forceinline__ float at(int f, int y, int x) const {
    return row(f, y)[x];
  }
  __device__ __forceinline__ float* mine(int f, int y) const {
    return here + f * fs + (y - y_lo) * W;
  }
};

// The fields, in shared-memory order.
enum Field { P, DENS, UN, VN, GUX, GUY, GVX, GVY, U2, V2 };

// df/dx and df/dy of field f at (y, x): central, one-sided at the image
// edge (the staged kernel's expressions).
template <bool SPLIT>
__device__ __forceinline__ float grad_x(const Slab<SPLIT>& s, int f, int y,
                                        int x, float dx) {
  const float* row = s.row(f, y);
  if (x == 0) return (row[1] - row[0]) / dx;
  if (x == s.W - 1) return (row[s.W - 1] - row[s.W - 2]) / dx;
  return (row[x + 1] - row[x - 1]) / dx / 2.f;
}

template <bool SPLIT>
__device__ __forceinline__ float grad_y(const Slab<SPLIT>& s, int f, int y,
                                        int x, int H, float dx) {
  if (y == 0) return (s.at(f, 1, x) - s.at(f, 0, x)) / dx;
  if (y == H - 1) return (s.at(f, H - 1, x) - s.at(f, H - 2, x)) / dx;
  return (s.at(f, y + 1, x) - s.at(f, y - 1, x)) / dx / 2.f;
}

// CIP advection of field f, with its gradient fields fx, fy, at (y, x) by
// the velocity (uc, vc) of that cell.
template <bool SPLIT>
__device__ float cip(const Slab<SPLIT>& s, int f, int fx, int fy, int y,
                     int x, int H, float uc, float vc, const Consts& k) {
  const bool xp = uc >= 0.f;
  const bool yp = vc >= 0.f;
  const float x_sf = xp ? 1.f : -1.f;
  const float y_sf = yp ? 1.f : -1.f;
  const int xm = reflect(xp ? x - 1 : x + 1, s.W);   // upwind column
  const int ym = reflect(yp ? y - 1 : y + 1, H);     // upwind row
  const float dx = k.dx;
  // Row y is this block's; row ym may be a neighbour's.  Every field sits
  // at the same offset from its row's start.
  const float* r = s.row(f, y) - f * s.fs;
  const float* rm = s.row(f, ym) - f * s.fs;

  const float dens = r[f * s.fs + x];
  const float d_xm = r[f * s.fs + xm];
  const float d_ym = rm[f * s.fs + x];
  const float d_xym = rm[f * s.fs + xm];
  const float dens_dx = r[fx * s.fs + x];
  const float dens_dy = r[fy * s.fs + x];
  const float dx_xm = r[fx * s.fs + xm];
  const float dx_ym = rm[fx * s.fs + x];
  const float dy_xm = r[fy * s.fs + xm];
  const float dy_ym = rm[fy * s.fs + x];

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

template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p) {
  Vec<VEC> out;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out.v[0] = t.x;
    out.v[1] = t.y;
    out.v[2] = t.z;
    out.v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.v[j] = p[j];
  }
  return out;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& in) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(in.v[0], in.v[1], in.v[2], in.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = in.v[j];
  }
}

// One cluster of `cluster` blocks per image (grid (cluster, images), looped
// past 65535 images); block r holds rows [r * rows, (r + 1) * rows).  VEC =
// 4: 16-byte loads and stores (H * W a multiple of 4), else 1.  Each thread
// takes groups of VEC consecutive pixels of the block's rows.
template <int VEC, bool SPLIT, int NT>
__global__ void __launch_bounds__(NT) ns_step_kernel(
    const float* __restrict__ dens, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ p,
    float* __restrict__ dens_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ p_out, int B, int H,
    int W, Consts k) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  extern __shared__ float4 smem4[];
  Slab<SPLIT> s;
  s.here = reinterpret_cast<float*>(smem4);
  s.rows = H / nblk;
  s.y_lo = rank * s.rows;
  s.W = W;
  s.fs = s.rows * W;
  s.prev = rank > 0 ? cluster.map_shared_rank(s.here, rank - 1) : s.here;
  s.next = rank + 1 < nblk ? cluster.map_shared_rank(s.here, rank + 1)
                           : s.here;
  const int n = s.rows * W;                  // this block's pixels
  const int step = NT * VEC;
  const int first = threadIdx.x * VEC;
  float* sp = s.here + P * s.fs;
  float* sd = s.here + DENS * s.fs;

  for (int bi = blockIdx.y; bi < B; bi += gridDim.y) {
    const int64_t base = int64_t(bi) * H * W + int64_t(s.y_lo) * W;

    for (int i = first; i < n; i += step) {
      store<VEC>(sp + i, load<VEC>(p + base + i));
      store<VEC>(sd + i, load<VEC>(dens + base + i));
    }
    cluster.sync();

    // Stage 1: the pressure-gradient velocity update.
    for (int i = first; i < n; i += step) {
      const Vec<VEC> ui = load<VEC>(u + base + i);
      const Vec<VEC> vi = load<VEC>(v + base + i);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int y = s.y_lo + (i + j) / W;
        const int x = (i + j) % W;
        s.mine(UN, y)[x] = ui.v[j] - grad_x(s, P, y, x, k.dx) * k.dt;
        s.mine(VN, y)[x] = vi.v[j] - grad_y(s, P, y, x, H, k.dx) * k.dt;
      }
    }
    cluster.sync();

    // The gradients of u_n and v_n, once a pixel.
    for (int i = first; i < n; i += step) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int y = s.y_lo + (i + j) / W;
        const int x = (i + j) % W;
        s.mine(GUX, y)[x] = grad_x(s, UN, y, x, k.dx);
        s.mine(GUY, y)[x] = grad_y(s, UN, y, x, H, k.dx);
        s.mine(GVX, y)[x] = grad_x(s, VN, y, x, k.dx);
        s.mine(GVY, y)[x] = grad_y(s, VN, y, x, H, k.dx);
      }
    }
    cluster.sync();

    // Stage 2: CIP self-advection of u_n and v_n by (u_n, v_n).
    for (int i = first; i < n; i += step) {
      Vec<VEC> uo, vo;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int y = s.y_lo + (i + j) / W;
        const int x = (i + j) % W;
        const float uc = s.mine(UN, y)[x];
        const float vc = s.mine(VN, y)[x];
        uo.v[j] = cip(s, UN, GUX, GUY, y, x, H, uc, vc, k);
        vo.v[j] = cip(s, VN, GVX, GVY, y, x, H, uc, vc, k);
      }
      store<VEC>(s.here + U2 * s.fs + i, uo);
      store<VEC>(s.here + V2 * s.fs + i, vo);
      store<VEC>(u_out + base + i, uo);
      store<VEC>(v_out + base + i, vo);
    }
    cluster.sync();

    // Stage 3: pressure relaxation; and dens's gradients for stage 4 (into
    // the u_n gradients' arrays, which stage 2 no longer reads).
    for (int i = first; i < n; i += step) {
      Vec<VEC> po;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int y = s.y_lo + (i + j) / W;
        const int x = (i + j) % W;
        const int xl = reflect(x - 1, W);
        const int xr = reflect(x + 1, W);
        const int yu = reflect(y - 1, H);
        const int yd = reflect(y + 1, H);
        const float aver_p = 0.25f * (s.at(P, y, xl) + s.at(P, y, xr)
                                      + s.at(P, yu, x) + s.at(P, yd, x));
        const float u_xx = s.at(U2, y, xr) - s.at(U2, y, xl);
        const float v_xx = s.at(V2, y, xr) - s.at(V2, y, xl);
        const float u_yy = s.at(U2, yd, x) - s.at(U2, yu, x);
        const float v_yy = s.at(V2, yd, x) - s.at(V2, yu, x);
        po.v[j] = aver_p + (u_xx * u_xx + v_yy * v_yy + u_yy * v_xx) / 8.f
                  - k.dx * (u_xx + v_yy) / k.dt8;
        s.mine(GUX, y)[x] = grad_x(s, DENS, y, x, k.dx);
        s.mine(GUY, y)[x] = grad_y(s, DENS, y, x, H, k.dx);
      }
      store<VEC>(p_out + base + i, po);
    }
    cluster.sync();

    // Stage 4: CIP advection of dens by (u2, v2).
    for (int i = first; i < n; i += step) {
      Vec<VEC> dout;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int y = s.y_lo + (i + j) / W;
        const int x = (i + j) % W;
        dout.v[j] = cip(s, DENS, GUX, GUY, y, x, H, s.mine(U2, y)[x],
                        s.mine(V2, y)[x], k);
      }
      store<VEC>(dens_out + base + i, dout);
    }
    // The next image overwrites the fields; no block leaves while another
    // still reads its rows.
    cluster.sync();
  }
}

template <int VEC, bool SPLIT, int NT>
int launch(const float* dens, const float* u, const float* v, const float* p,
           float* dens_out, float* u_out, float* v_out, float* p_out, int B,
           int H, int W, const Consts& k, int cluster, int smem,
           cudaStream_t s) {
  auto kernel = ns_step_kernel<VEC, SPLIT, NT>;
  static bool smem_set = false;    // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return int(err);
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(cluster), unsigned(B < MAX_GRID ? B : MAX_GRID));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;   // one block an image: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, dens, u, v, p,
                                             dens_out, u_out, v_out, p_out, B,
                                             H, W, k);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// All fields (B, H, W) float32, contiguous; H and W >= 2; `cluster` (1, 2,
// 4 or 8) blocks an image, dividing H; smem_bytes = 40 * (H / cluster) * W,
// the ten fields of a block's rows, within 227 KB (ops/ns_step.py
// `ns_step_plan`).  vec = 1: 16-byte loads and stores (one block an image,
// H * W a multiple of 4, every pointer 16-byte aligned).  dx3 = dx^3 and dt8 =
// 8 * dt, as the reference rounds them.  Returns cudaGetLastError() after
// the launch (0 on success), or the error of a refused launch.
extern "C" int ns_step_f32(const void* dens, const void* u, const void* v,
                           const void* p, void* dens_out, void* u_out,
                           void* v_out, void* p_out, int B, int H, int W,
                           float dt, float dx, float dx3, float dt8,
                           int cluster, int vec, int smem_bytes,
                           void* stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(dens) | reinterpret_cast<uintptr_t>(u) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(p) |
      reinterpret_cast<uintptr_t>(dens_out) |
      reinterpret_cast<uintptr_t>(u_out) |
      reinterpret_cast<uintptr_t>(v_out) | reinterpret_cast<uintptr_t>(p_out);
  if (B <= 0 || H < 2 || W < 2 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      H % cluster ||
      int64_t(FIELDS) * (H / cluster) * W * 4 != int64_t(smem_bytes) ||
      smem_bytes > SMEM_LIMIT ||
      (vec && (cluster > 1 || (H * W) % 4 || align % 16))) {
    return int(cudaErrorInvalidValue);
  }
  const Consts k{dt, dx, dx3, dt8};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto in = [](const void* t) { return static_cast<const float*>(t); };
  auto out = [](void* t) { return static_cast<float*>(t); };
  if (cluster > 1) {
    return launch<1, true, SPLIT_THREADS>(
        in(dens), in(u), in(v), in(p), out(dens_out), out(u_out), out(v_out),
        out(p_out), B, H, W, k, cluster, smem_bytes, s);
  }
  return vec ? launch<4, false, THREADS>(
                   in(dens), in(u), in(v), in(p), out(dens_out), out(u_out),
                   out(v_out), out(p_out), B, H, W, k, 1, smem_bytes, s)
             : launch<1, false, THREADS>(
                   in(dens), in(u), in(v), in(p), out(dens_out), out(u_out),
                   out(v_out), out(p_out), B, H, W, k, 1, smem_bytes, s);
}
