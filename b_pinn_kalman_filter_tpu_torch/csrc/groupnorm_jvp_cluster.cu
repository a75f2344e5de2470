// The tangent (forward-mode JVP) of act(GroupNorm(x)) over NHWC activations,
// with a per-channel affine: dy along (dx, dscale, dbias).
//
// Replaces no TPU kernel of its own: it is the forward-mode rule of the TPU
// kernel `groupnorm_act` (b_pinn_kalman_filter_tpu/ops/groupnorm_pallas.py
// :118), whose custom_vjp has no forward mode; the JAX package takes the
// likelihood's JVP through XLA's GroupNorm (core/likelihood.py:23-31).  The
// port's K2 always runs on the card, so its Function carries this rule.
//
// Per (image, group) of n elements, with mu, r = 1/sqrt(var + eps) and
// xh = (x - mu) r computed as csrc/groupnorm.cu computes them (same
// cluster, threads, vector width and sums, in the same order, so mu and r
// are K2's bits), m1 = mean(dx) and m2 = mean(xh dx):
//   dxh = r (dx - m1 - xh m2),  z = scale xh + bias,
//   dz = scale dxh + dscale xh + dbias,  dy = act'(z) dz.
// Per channel that is dz = A dx + Bc (x - mu) + Cc with A = r scale,
// Bc = r (dscale - A m2) and Cc = dbias - A m1.  y itself is not written:
// the Function's forward gave it by a K2 launch.
//
// What bounds it on an H100: bytes.  It reads x and dx and writes dy, about
// 25 operations an element: 1.5 times K2's bytes, far below the card's
// balance point.
//
// Design: K2's layout, with dx beside x.
// - A cluster of `cluster` blocks per image (grid (cluster, B)); block r
//   owns pixels [r*rows, (r+1)*rows) x all C channels.  Threads read whole
//   pixel rows, `vec` channels a load, as R rows x Q columns, and keep
//   their sums per channel in registers.
// - Pass 1 sums x and dx per channel; pass 2 sums (x - mu)^2 and
//   (x - mu) dx.  Each per-channel sum goes through one plane of shared
//   memory ([R][C], summed over R in a fixed order), then through
//   distributed shared memory over the cluster's blocks in rank order: the
//   same bits every run.
// - Both slices stay in shared memory (input dtype) when they fit (`on_chip`,
//   ops/groupnorm.py `jvp_plan`); else passes 2 and 3 read them from device
//   memory again (mostly from L2).
// - Pass 3 computes dy and stores it with the same vector width.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;      // portable cluster size
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (H100)
constexpr int UNROLL = 4;           // pixel rows a thread has in flight

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);   // round to nearest even, as torch's cast
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Floats before the slice copies: red [R][C] (one plane, reused), the
// block's per-channel sums cs[4][C] (x, dx, (x-mu)^2, (x-mu) dx: each read
// by the cluster's other blocks, so none is overwritten while they may read
// it), the cluster's totals ctot[2][C], scale, bias, dscale, dbias, and the
// group mu, r, m1, m2.  Rounded up to 4 floats so the copies are 16-byte
// aligned.  ops/groupnorm.py `jvp_plan` counts the same.
__host__ __device__ __forceinline__ int stat_floats(int R, int C, int G) {
  return (R * C + 10 * C + 4 * G + 3) / 4 * 4;
}

// Sum red[i][c] over the R rows into out[c], in row order.
template <int THREADS>
__device__ __forceinline__ void sum_rows(const float* red, float* out, int R,
                                         int C) {
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s = 0.f;
    for (int i = 0; i < R; ++i) s += red[i * C + c];
    out[c] = s;
  }
}

// act: 0 = none, 1 = silu, 2 = elu.
template <typename T, int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS) groupnorm_act_jvp_kernel(
    const T* __restrict__ x, const T* __restrict__ dx,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ dscale, const float* __restrict__ dbias,
    T* __restrict__ dy, int P, int C, int G, int act, float eps, int Q,
    int on_chip) {
  using V = Vec<T, VEC>;
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int R = THREADS / Q;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  float* cs = red + R * C;          // [4][C]
  float* ctot = cs + 4 * C;         // [2][C]
  float* sscale = ctot + 2 * C;
  float* sbias = sscale + C;
  float* sdscale = sbias + C;
  float* sdbias = sdscale + C;
  float* gmean = sdbias + C;
  float* grstd = gmean + G;
  float* gm1 = grstd + G;
  float* gm2 = gm1 + G;

  const int rows = (P + nblk - 1) / nblk;
  const int p0 = min(P, rank * rows);
  const int np = min(P, p0 + rows) - p0;
  const int tpp = C / VEC;                  // vectors per pixel
  V* copy = reinterpret_cast<V*>(red + stat_floats(R, C, G));
  V* dcopy = copy + int64_t(rows) * tpp;
  const int64_t base = (int64_t(blockIdx.y) * P + p0) * C;
  const V* xs = reinterpret_cast<const V*>(x + base);
  const V* dxs = reinterpret_cast<const V*>(dx + base);
  V* dys = reinterpret_cast<V*>(dy + base);
  const int q = threadIdx.x % Q;
  const int r = threadIdx.x / Q;
  const bool active = r < R;
  const int cg_size = C / G;
  const float count = float(P) * float(cg_size);

  for (int c = threadIdx.x; c < C; c += THREADS) {
    sscale[c] = scale[c];
    sbias[c] = bias[c];
    sdscale[c] = dscale ? dscale[c] : 0.f;
    sdbias[c] = dbias ? dbias[c] : 0.f;
  }

  // Pass 1: per-channel sums of x, as K2's pass 1 (and the on-chip copies
  // of x and dx); then of dx.  One plane of shared memory takes each in
  // turn.
  if (active) {
    for (int col = q; col < tpp; col += Q) {
      float s[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] = 0.f;
      for (int row0 = r; row0 < np; row0 += UNROLL * R) {
        V v[UNROLL], dv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int row = row0 + u * R;
          if (row < np) {
            v[u] = xs[int64_t(row) * tpp + col];
            if (on_chip) dv[u] = dxs[int64_t(row) * tpp + col];
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int row = row0 + u * R;
          if (row < np) {
            if (on_chip) {
              copy[int64_t(row) * tpp + col] = v[u];
              dcopy[int64_t(row) * tpp + col] = dv[u];
            }
#pragma unroll
            for (int j = 0; j < VEC; ++j) s[j] += to_float(v[u].v[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[r * C + col * VEC + j] = s[j];
    }
  }
  __syncthreads();
  sum_rows<THREADS>(red, cs, R, C);
  __syncthreads();
  if (active) {
    for (int col = q; col < tpp; col += Q) {
      float s[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] = 0.f;
      for (int row = r; row < np; row += R) {
        const int64_t e = int64_t(row) * tpp + col;
        const V dv = on_chip ? dcopy[e] : dxs[e];
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[j] += to_float(dv.v[j]);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[r * C + col * VEC + j] = s[j];
    }
  }
  __syncthreads();
  sum_rows<THREADS>(red, cs + C, R, C);
  cluster.sync();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {   // in rank order
      if (k < nblk) {
        const float* remote = cluster.map_shared_rank(cs, k);
        a += remote[c];
        b += remote[C + c];
      }
    }
    ctot[c] = a;
    ctot[C + c] = b;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float a = 0.f, b = 0.f;
    for (int c = g * cg_size; c < (g + 1) * cg_size; ++c) {
      a += ctot[c];
      b += ctot[C + c];
    }
    gmean[g] = a / count;
    gm1[g] = b / count;
  }
  __syncthreads();

  // Pass 2: per-channel sums of (x - mu)^2, as K2's pass 2; then of
  // (x - mu) dx.
  if (active) {
    for (int col = q; col < tpp; col += Q) {
      float m[VEC], s[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        m[j] = gmean[(col * VEC + j) / cg_size];
        s[j] = 0.f;
      }
      for (int row0 = r; row0 < np; row0 += UNROLL * R) {
        V v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int row = row0 + u * R;
          const int64_t e = int64_t(row) * tpp + col;
          if (row < np) v[u] = on_chip ? copy[e] : xs[e];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (row0 + u * R < np) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float d = to_float(v[u].v[j]) - m[j];
              s[j] = fmaf(d, d, s[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[r * C + col * VEC + j] = s[j];
    }
  }
  __syncthreads();
  sum_rows<THREADS>(red, cs + 2 * C, R, C);
  __syncthreads();
  if (active) {
    for (int col = q; col < tpp; col += Q) {
      float m[VEC], s[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        m[j] = gmean[(col * VEC + j) / cg_size];
        s[j] = 0.f;
      }
      for (int row = r; row < np; row += R) {
        const int64_t e = int64_t(row) * tpp + col;
        const V v = on_chip ? copy[e] : xs[e];
        const V dv = on_chip ? dcopy[e] : dxs[e];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[j] = fmaf(to_float(v.v[j]) - m[j], to_float(dv.v[j]), s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[r * C + col * VEC + j] = s[j];
    }
  }
  __syncthreads();
  sum_rows<THREADS>(red, cs + 3 * C, R, C);
  cluster.sync();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {   // in rank order
      if (k < nblk) {
        const float* remote = cluster.map_shared_rank(cs, k);
        a += remote[2 * C + c];
        b += remote[3 * C + c];
      }
    }
    ctot[c] = a;
    ctot[C + c] = b;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float a = 0.f, b = 0.f;
    for (int c = g * cg_size; c < (g + 1) * cg_size; ++c) {
      a += ctot[c];
      b += ctot[C + c];
    }
    const float rstd = rsqrtf(a / count + eps);
    grstd[g] = rstd;
    gm2[g] = rstd * (b / count);      // mean(xh dx)
  }
  // Also a block barrier for grstd and gm2, and no block leaves while
  // another still reads its sums.
  cluster.sync();

  // Pass 3: dy = act'(z) (A dx + Bc (x - mu) + Cc), z = A (x - mu) + bias.
  if (active) {
    for (int col = q; col < tpp; col += Q) {
      float m[VEC], a[VEC], b[VEC], bc[VEC], cc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ch = col * VEC + j;
        const int g = ch / cg_size;
        const float rstd = grstd[g];
        m[j] = gmean[g];
        a[j] = rstd * sscale[ch];
        b[j] = sbias[ch];
        bc[j] = rstd * (sdscale[ch] - a[j] * gm2[g]);
        cc[j] = sdbias[ch] - a[j] * gm1[g];
      }
      for (int row0 = r; row0 < np; row0 += UNROLL * R) {
        V v[UNROLL], dv[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int row = row0 + u * R;
          const int64_t e = int64_t(row) * tpp + col;
          if (row < np) {
            v[u] = on_chip ? copy[e] : xs[e];
            dv[u] = on_chip ? dcopy[e] : dxs[e];
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int row = row0 + u * R;
          if (row >= np) continue;
          V out;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float d = to_float(v[u].v[j]) - m[j];
            const float z = d * a[j] + b[j];
            float t = fmaf(a[j], to_float(dv[u].v[j]), fmaf(bc[j], d, cc[j]));
            if (act == 1) {
              const float sg = 1.f / (1.f + expf(-z));
              t *= sg * (1.f + z * (1.f - sg));
            } else if (act == 2) {
              t *= z > 0.f ? 1.f : expf(z);
            }
            out.v[j] = from_float<T>(t);
          }
          dys[int64_t(row) * tpp + col] = out;
        }
      }
    }
  }
}

template <typename T, int VEC, int THREADS>
int launch(const void* x, const void* dx, const float* scale,
           const float* bias, const float* dscale, const float* dbias,
           void* dy, int B, int P, int C, int G, int act, float eps,
           int cluster, int Q, int on_chip, int smem_bytes, cudaStream_t s) {
  auto kernel = groupnorm_act_jvp_kernel<T, VEC, THREADS>;
  static bool smem_set = false;    // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return int(err);
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(cluster), unsigned(B));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = size_t(smem_bytes);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;   // one block: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(dx),
      scale, bias, dscale, dbias, static_cast<T*>(dy), P, C, G, act, eps, Q,
      on_chip);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T, int VEC>
int launch_threads(int threads, const void* x, const void* dx,
                   const float* scale, const float* bias, const float* dscale,
                   const float* dbias, void* dy, int B, int P, int C, int G,
                   int act, float eps, int cluster, int Q, int on_chip,
                   int smem_bytes, cudaStream_t s) {
  return threads == 256
      ? launch<T, VEC, 256>(x, dx, scale, bias, dscale, dbias, dy, B, P, C,
                            G, act, eps, cluster, Q, on_chip, smem_bytes, s)
      : launch<T, VEC, 512>(x, dx, scale, bias, dscale, dbias, dy, B, P, C,
                            G, act, eps, cluster, Q, on_chip, smem_bytes, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dx and dy share it; scale, bias,
// dscale and dbias are float32, dscale and dbias null for a zero tangent).
// The plan (cluster size, threads a block, vector width, thread columns Q,
// whether the slices stay on chip, and the shared-memory bytes) comes from
// ops/groupnorm.py `jvp_plan`.  Returns cudaGetLastError() after the launch
// (0 on success), or the error of a refused launch.
extern "C" int groupnorm_act_jvp_nhwc(const void* x, const void* dx,
                                      const void* scale, const void* bias,
                                      const void* dscale, const void* dbias,
                                      void* dy, int B, int HW, int C, int G,
                                      int act, float eps, int dtype,
                                      int cluster, int threads, int vec,
                                      int Q, int on_chip, int smem_bytes,
                                      void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int64_t rows = (HW + cluster - 1) / cluster;
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || act < 0 ||
      act > 2 || dtype < 0 || dtype > 1 || cluster < 1 ||
      cluster > MAX_CLUSTER || (threads != 256 && threads != 512) ||
      (vec != 1 && vec * itemsize != 16) || C % vec != 0 || Q < 1 ||
      Q > threads || Q > C / vec ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dx) |
       reinterpret_cast<uintptr_t>(dy)) % (vec * itemsize) ||
      smem_bytes > SMEM_LIMIT ||
      smem_bytes < 4 * stat_floats(threads / Q, C, G) +
                       (on_chip ? 2 * rows * C * itemsize : 0)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* dsc = static_cast<const float*>(dscale);
  const float* dbi = static_cast<const float*>(dbias);
  if (dtype == 0) {
    return vec == 4
        ? launch_threads<float, 4>(threads, x, dx, sc, bi, dsc, dbi, dy, B,
                                   HW, C, G, act, eps, cluster, Q, on_chip,
                                   smem_bytes, s)
        : launch_threads<float, 1>(threads, x, dx, sc, bi, dsc, dbi, dy, B,
                                   HW, C, G, act, eps, cluster, Q, on_chip,
                                   smem_bytes, s);
  }
  return vec == 8
      ? launch_threads<__nv_bfloat16, 8>(threads, x, dx, sc, bi, dsc, dbi, dy,
                                         B, HW, C, G, act, eps, cluster, Q,
                                         on_chip, smem_bytes, s)
      : launch_threads<__nv_bfloat16, 1>(threads, x, dx, sc, bi, dsc, dbi, dy,
                                         B, HW, C, G, act, eps, cluster, Q,
                                         on_chip, smem_bytes, s);
}
