// act(GroupNorm(x)) over NHWC activations, with a per-channel affine.
//
// Replaces the TPU kernel `groupnorm_act`
// (b_pinn_kalman_filter_tpu/ops/groupnorm_pallas.py:118, pallas_call in
// `_pallas_groupnorm_act` :164): statistics in f32, eps added to the
// variance, per-channel scale and bias, then SiLU, ELU or nothing, written
// in the input dtype.
//
// What bounds it on an H100: bytes.  It does about ten operations per
// element against one read and one write of the activation, far below the
// card's balance point, so the least time is 2 * B*H*W*C * itemsize bytes
// over the memory rate.  At the U-Net's shapes (at most 786 KB an image)
// that bound is under a microsecond, so latency is what a design can lose.
//
// Design: one read and one write of device memory.
// - A thread-block cluster of `cluster` blocks per image (grid (cluster,
//   B)); block r owns the contiguous slice of pixels
//   [r*rows, (r+1)*rows) x all C channels, rows = ceil(H*W / cluster).
//   The cluster grows (up to 8) only while each block keeps at least 16 KB:
//   a small image is one block, launched without a cluster (a cluster
//   launch costs more), and needs no cross-block
//   sums.
// - 256 threads a block where its slice is at most 16 KB, else 512 (the
//   small slices are latency-bound: fewer threads, shorter barriers).
//   Threads read whole pixel rows, `vec` channels a load (16 bytes when
//   C * itemsize is a multiple of 16, else one element): the threads form R
//   rows x Q columns, Q = min(C/vec, threads), so a thread always sees the
//   same channels and keeps its sums per channel in registers.  Per-channel
//   sums go through shared memory ([R][C], summed over R in a fixed order).
//   Each thread issues UNROLL row loads before it uses any of them.
// - The slice stays in shared memory (input dtype) between the statistics
//   and the normalisation when it fits (`on_chip`; 98 KB a block at the
//   largest U-Net site, 32x32x384 bf16 over 8 blocks).  When it does not,
//   the same kernel reads the slice from device memory again for the second
//   and third pass (mostly from L2): right at any size, at up to three
//   reads.
// - Mean, then the variance as the mean of (x - mean)^2 (a second pass over
//   the on-chip copy; never E[x^2] - E[x]^2).  Each needs the whole image:
//   every block sums the per-channel sums of the cluster's blocks through
//   distributed shared memory, in rank order (so the result does not change
//   from run to run), after a cluster barrier.
// - The third pass normalises, applies the affine and the activation and
//   stores, with the same vector width.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (H100)
constexpr int UNROLL = 4;         // pixel rows a thread has in flight

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

// Floats before the slice copy in shared memory: red [R][C], the block's
// per-channel sums (csum) and squared deviations (csq), the cluster's
// per-channel totals (ctot), the scale and bias, and the group means and
// 1/std.  Rounded up to 4 floats so the copy is 16-byte aligned.
__host__ __device__ __forceinline__ int stat_floats(int R, int C, int G) {
  return (R * C + 5 * C + 2 * G + 3) / 4 * 4;
}

// act: 0 = none, 1 = silu, 2 = elu.
template <typename T, int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS) groupnorm_act_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ y, int P, int C, int G,
    int act, float eps, int Q, int on_chip) {
  using V = Vec<T, VEC>;
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int R = THREADS / Q;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  float* csum = red + R * C;
  float* csq = csum + C;
  float* ctot = csq + C;
  float* sscale = ctot + C;
  float* sbias = sscale + C;
  float* gmean = sbias + C;
  float* grstd = gmean + G;
  V* copy = reinterpret_cast<V*>(red + stat_floats(R, C, G));

  const int rows = (P + nblk - 1) / nblk;
  const int p0 = min(P, rank * rows);
  const int np = min(P, p0 + rows) - p0;
  const int64_t base = (int64_t(blockIdx.y) * P + p0) * C;
  const V* xs = reinterpret_cast<const V*>(x + base);
  V* ys = reinterpret_cast<V*>(y + base);
  const int tpp = C / VEC;                  // vectors per pixel
  const int q = threadIdx.x % Q;
  const int r = threadIdx.x / Q;
  const bool active = r < R;
  const int cg_size = C / G;
  const float count = float(P) * float(cg_size);

  // The affine's loads start now and land while pass 1 reads.
  for (int c = threadIdx.x; c < C; c += THREADS) {
    sscale[c] = scale[c];
    sbias[c] = bias[c];
  }

  // Pass 1: per-channel sums (and the on-chip copy).
  if (active) {
    for (int col = q; col < tpp; col += Q) {
      float s[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] = 0.f;
      for (int row0 = r; row0 < np; row0 += UNROLL * R) {
        V v[UNROLL];            // UNROLL loads in flight before any use
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int row = row0 + u * R;
          if (row < np) v[u] = xs[int64_t(row) * tpp + col];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int row = row0 + u * R;
          if (row < np) {
            if (on_chip) copy[int64_t(row) * tpp + col] = v[u];
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
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s = 0.f;
    for (int i = 0; i < R; ++i) s += red[i * C + c];
    csum[c] = s;
  }
  cluster.sync();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {   // in rank order
      if (k < nblk) s += cluster.map_shared_rank(csum, k)[c];
    }
    ctot[c] = s;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float s = 0.f;
    for (int c = g * cg_size; c < (g + 1) * cg_size; ++c) s += ctot[c];
    gmean[g] = s / count;
  }
  __syncthreads();

  // Pass 2: per-channel sums of squared deviations from the group mean.
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
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s = 0.f;
    for (int i = 0; i < R; ++i) s += red[i * C + c];
    csq[c] = s;
  }
  cluster.sync();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {   // in rank order
      if (k < nblk) s += cluster.map_shared_rank(csq, k)[c];
    }
    ctot[c] = s;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float s = 0.f;
    for (int c = g * cg_size; c < (g + 1) * cg_size; ++c) s += ctot[c];
    grstd[g] = rsqrtf(s / count + eps);
  }
  // Also a block barrier for grstd, and no block leaves (or reuses csq)
  // while another still reads its sums.
  cluster.sync();

  // Pass 3: normalise, affine, activation, store.
  if (active) {
    for (int col = q; col < tpp; col += Q) {
      float m[VEC], a[VEC], b[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ch = col * VEC + j;
        const int g = ch / cg_size;
        m[j] = gmean[g];
        a[j] = grstd[g] * sscale[ch];
        b[j] = sbias[ch];
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
          const int row = row0 + u * R;
          if (row >= np) continue;
          V out;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float t = (to_float(v[u].v[j]) - m[j]) * a[j] + b[j];
            if (act == 1) {
              t = t / (1.f + expf(-t));
            } else if (act == 2) {
              t = t > 0.f ? t : expm1f(t);
            }
            out.v[j] = from_float<T>(t);
          }
          ys[int64_t(row) * tpp + col] = out;
        }
      }
    }
  }
}

template <typename T, int VEC, int THREADS>
int launch(const void* x, const float* scale, const float* bias, void* y,
           int B, int P, int C, int G, int act, float eps, int cluster, int Q,
           int on_chip, int smem_bytes, cudaStream_t s) {
  auto kernel = groupnorm_act_kernel<T, VEC, THREADS>;
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
      &cfg, kernel, static_cast<const T*>(x), scale, bias, static_cast<T*>(y),
      P, C, G, act, eps, Q, on_chip);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

template <typename T, int VEC>
int launch_threads(int threads, const void* x, const float* scale,
                   const float* bias, void* y, int B, int P, int C, int G,
                   int act, float eps, int cluster, int Q, int on_chip,
                   int smem_bytes, cudaStream_t s) {
  return threads == 256
      ? launch<T, VEC, 256>(x, scale, bias, y, B, P, C, G, act, eps, cluster,
                            Q, on_chip, smem_bytes, s)
      : launch<T, VEC, 512>(x, scale, bias, y, B, P, C, G, act, eps, cluster,
                            Q, on_chip, smem_bytes, s);
}

// dtype: 0 = float32, 1 = bfloat16 (x and y share it; scale and bias are
// float32).  The plan (cluster size, threads a block, vector width, thread
// columns Q, whether the slice stays on chip, and the shared-memory bytes)
// comes from ops/groupnorm.py `groupnorm_plan`.  Returns cudaGetLastError() after the
// launch (0 on success), or the error of a refused launch.
extern "C" int groupnorm_act_nhwc(const void* x, const void* scale,
                                  const void* bias, void* y, int B, int HW,
                                  int C, int G, int act, float eps, int dtype,
                                  int cluster, int threads, int vec, int Q,
                                  int on_chip, int smem_bytes, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || act < 0 ||
      act > 2 || dtype < 0 || dtype > 1 || cluster < 1 ||
      cluster > MAX_CLUSTER || (threads != 256 && threads != 512) ||
      (vec != 1 && vec * itemsize != 16) || C % vec != 0 || Q < 1 ||
      Q > threads || Q > C / vec ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
          (vec * itemsize) ||
      smem_bytes > SMEM_LIMIT ||
      smem_bytes < 4 * stat_floats(threads / Q, C, G) +
                       (on_chip ? int64_t((HW + cluster - 1) / cluster) * C *
                                      itemsize
                                : 0)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0) {
    return vec == 4
        ? launch_threads<float, 4>(threads, x, sc, bi, y, B, HW, C, G, act,
                                   eps, cluster, Q, on_chip, smem_bytes, s)
        : launch_threads<float, 1>(threads, x, sc, bi, y, B, HW, C, G, act,
                                   eps, cluster, Q, on_chip, smem_bytes, s);
  }
  return vec == 8
      ? launch_threads<__nv_bfloat16, 8>(threads, x, sc, bi, y, B, HW, C, G,
                                         act, eps, cluster, Q, on_chip,
                                         smem_bytes, s)
      : launch_threads<__nv_bfloat16, 1>(threads, x, sc, bi, y, B, HW, C, G,
                                         act, eps, cluster, Q, on_chip,
                                         smem_bytes, s);
}
