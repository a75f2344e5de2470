// The tangent (forward-mode JVP) of act(GroupNorm(x)) over NHWC activations,
// with a per-channel affine: dy along (dx, dscale, dbias).
//
// Replaces no TPU kernel of its own: it is the forward-mode rule of the TPU
// kernel `groupnorm_act` (b_pinn_kalman_filter_tpu/ops/groupnorm_pallas.py
// :118, pallas_call :164), whose custom_vjp has no forward mode; the JAX
// package takes the likelihood's JVP through XLA's GroupNorm
// (core/likelihood.py:23-31).  The port's K2 always runs on the card, so
// its Function carries this rule.
//
// Per (image, group) of n elements, with mu, r = 1/sqrt(var + eps),
// xh = (x - mu) r, m1 = mean(dx) and m2 = mean(xh dx):
//   dxh = r (dx - m1 - xh m2),  z = scale xh + bias,
//   dz = scale dxh + dscale xh + dbias,  dy = act'(z) dz.
// Per channel that is dz = A dx + Bc (x - mu) + Cc with A = r scale,
// Bc = r (dscale - A m2) and Cc = dbias - A m1.  y itself is not written:
// the Function's forward gave it by a K2 launch.
//
// What bounds it on an H100: bytes.  It reads x and dx and writes dy, about
// 25 operations an element, far below the card's balance point.  At the
// flagship's batch 8 a launch moves ~3 MB (~1 us at 3.35 TB/s), so there
// the chain of dependent steps inside a block sets its time; at batch 256
// the bytes do.
//
// Design (ops/groupnorm.py `jvp_plan` sizes it):
// - One statistics pass.  A thread keeps, per channel of its 16-byte
//   vector, sums of x - K, (x - K)^2, dx and (x - K) dx, where the shift K
//   is the group's first element of the image (pixel 0): every block of an
//   image shifts by the same K, so the sums combine, and a shift inside the
//   group's range keeps var = E[(x-K)^2] - E[x-K]^2 free of the
//   cancellation an unshifted E[x^2] - mu^2 suffers.  So the statistics
//   take one pass and one cluster exchange, not two of each.
// - The slices stream in through the TMA: a block's pixels are one
//   contiguous run of x and one of dx, cut into chunks of whole pixel rows,
//   each chunk one bulk copy (`cp.async.bulk`) of x and one of dx into a
//   ring stage with its own mbarrier.  All stages are in flight from the
//   start, and threads sum each chunk as it lands.  Where the ring holds the
//   whole slice (`stages == chunks`) the output pass reads it from shared
//   memory; else the ring streams the slice again (mostly from L2).
// - Blocks: up to 8 per image (a cluster), as few as keep a block's
//   slices of x and dx in its ring with at least two blocks an SM (~113 KB
//   each), and more where the grid is short of a wave (batch 8); one
//   block's barriers and stores overlap another's loads.
// - The per-thread sums go through one plane of shared memory ([2][R][C],
//   two quantities at a time) and are reduced over its R rows by the
//   threads that wrote them, in a fixed tree order; then per group, then
//   over the cluster through distributed shared memory in rank order.
//   Every sum runs in a fixed order, with no atomics: the same bits every
//   run.
// - The output pass computes dy per vector (SiLU's sigmoid by the fast
//   __expf and __fdividef: with the precise ones the pass's instructions
//   take about as long as its bytes) and stores it 16 bytes a thread.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;      // portable cluster size
constexpr int MAX_STAGES = 32;      // one parity bit each in a uint32
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may use (H100)

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

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Floats ahead of the mbarriers: the plane [2][R][C], the block's group
// sums [4][G], the cluster's totals turned into (mu, r, m1, m2) [4][G]
// and the groups' shifts [G].
__host__ __device__ __forceinline__ int head_floats(int R, int C, int G) {
  return 2 * R * C + 9 * G;
}

// Shared memory ahead of the ring: those floats, then the stages'
// mbarriers; ops/groupnorm.py `jvp_plan` counts the same.
__host__ __device__ __forceinline__ int head_bytes(int R, int C, int G) {
  return round_up(4 * head_floats(R, C, G), 128) +
         round_up(8 * MAX_STAGES, 128);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) from device memory into this
// block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// act: 0 = none, 1 = silu, 2 = elu.  Grid (cluster, B); block `rank` of an
// image owns pixels [rank * rows, (rank + 1) * rows).  TMA (VEC > 1: pixel
// rows of 16-byte multiples, 16-byte aligned tensors) streams the chunks;
// else (VEC == 1) the threads copy them element by element.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, 2) groupnorm_act_jvp_kernel(
    const T* __restrict__ x, const T* __restrict__ dx,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ dscale, const float* __restrict__ dbias,
    T* __restrict__ dy, int P, int C, int G, int act, float eps, int rows,
    int chunk_rows, int stages) {
  using V = Vec<T, VEC>;
  constexpr bool TMA = VEC > 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int tid = threadIdx.x;
  const int tpp = C / VEC;                  // vectors a pixel
  const int Q = tpp < THREADS ? tpp : THREADS;
  const int R = THREADS / Q;                // pixel rows a sweep
  const int q = tid % Q;
  const int r = tid / Q;
  const bool active = r < R;
  const int cg_size = C / G;
  const float count = float(P) * float(cg_size);

  extern __shared__ __align__(128) unsigned char smem[];
  float* plane = reinterpret_cast<float*>(smem);      // [2][R][C]
  float* gsum = plane + 2 * R * C;                     // [4][G]
  float* gstat = gsum + 4 * G;                         // mu, r, m1, m2
  float* gshift = gstat + 4 * G;                       // [G]
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + round_up(4 * head_floats(R, C, G), 128));
  unsigned char* ring = smem + head_bytes(R, C, G);
  const int row_elems = C;
  const int stage_bytes = round_up(chunk_rows * C * int(sizeof(T)), 128);

  const int p0 = min(P, rank * rows);
  const int np = min(P, p0 + rows) - p0;
  const int nchunks = (np + chunk_rows - 1) / chunk_rows;
  const bool on_chip = nchunks <= stages;
  const int64_t image = int64_t(blockIdx.y) * P * C;
  const T* xs = x + image + int64_t(p0) * C;
  const T* dxs = dx + image + int64_t(p0) * C;
  T* dys = dy + image + int64_t(p0) * C;

  auto stage_x = [&](int s) {
    return reinterpret_cast<T*>(ring + int64_t(2 * s) * stage_bytes);
  };
  auto stage_dx = [&](int s) {
    return reinterpret_cast<T*>(ring + int64_t(2 * s + 1) * stage_bytes);
  };
  auto chunk_len = [&](int k) {
    return min(chunk_rows, np - k * chunk_rows);
  };
  // Chunk k into stage k % stages: by one thread's two bulk copies (TMA),
  // or by every thread (the caller then synchronises the block).
  auto fill = [&](int k) {
    const int s = k % stages;
    const int64_t off = int64_t(k) * chunk_rows * row_elems;
    const int n = chunk_len(k) * row_elems;
    if (TMA) {
      const unsigned bytes = unsigned(n * sizeof(T));
      mbar_expect(&bar[s], 2 * bytes);
      bulk_load(stage_x(s), xs + off, bytes, &bar[s]);
      bulk_load(stage_dx(s), dxs + off, bytes, &bar[s]);
    } else {
      T* sx = stage_x(s);
      T* sdx = stage_dx(s);
      for (int e = tid; e < n; e += THREADS) {
        sx[e] = xs[off + e];
        sdx[e] = dxs[off + e];
      }
    }
  };
  unsigned phase = 0;   // parity of each stage's next completion
  auto wait = [&](int k) {
    if (TMA) {
      const int s = k % stages;
      mbar_wait(&bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
    }
  };
  // The first `stages` chunks into the ring, by one thread.
  auto prefill = [&]() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int k = 0; k < nchunks && k < stages; ++k) fill(k);
  };
  // Sweep chunks 0..nchunks-1 through the ring, calling body(k, stage x,
  // stage dx) on each as it lands.  `loaded`: the ring already holds them
  // all (the output pass of an on-chip slice); `prefilled`: the first
  // stages are already on their way.
  auto sweep = [&](bool loaded, bool prefilled, auto&& body) {
    if (TMA && !loaded && !prefilled && tid == 0) prefill();
    for (int k = 0; k < nchunks; ++k) {
      const int s = k % stages;
      if (!loaded) {
        if (TMA) {
          wait(k);
        } else {
          fill(k);
          __syncthreads();
        }
      }
      body(k, stage_x(s), stage_dx(s));
      if (!loaded && (!TMA || k + stages < nchunks)) {
        __syncthreads();   // every thread is done with stage s
        if (TMA && tid == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          fill(k + stages);
        }
      }
    }
  };

  // The slices' first chunks go out first; meanwhile the threads stage
  // each group's shift, its element at pixel 0 of the image.
  if (TMA && tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefill();
  }
  for (int g = tid; g < G; g += THREADS) {
    gshift[g] = to_float(x[image + g * cg_size]);
  }
  __syncthreads();
  float shift[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    shift[j] = gshift[(active ? q * VEC + j : 0) / cg_size];
  }

  // Statistics pass.
  float s1[VEC], s2[VEC], t1[VEC], t2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = t1[j] = t2[j] = 0.f;
  sweep(false, true, [&](int k, const T* sx, const T* sdx) {
    if (!active) return;
    const V* vx = reinterpret_cast<const V*>(sx);
    const V* vdx = reinterpret_cast<const V*>(sdx);
    const int n = chunk_len(k);
    for (int row = r; row < n; row += R) {
      const V a = vx[row * tpp + q];
      const V b = vdx[row * tpp + q];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = to_float(a.v[j]) - shift[j];
        const float e = to_float(b.v[j]);
        s1[j] += d;
        s2[j] = fmaf(d, d, s2[j]);
        t1[j] += e;
        t2[j] = fmaf(d, e, t2[j]);
      }
    }
  });

  // Per-channel sums over the plane's R rows, then per group: two
  // quantities a round.  The rows are summed by the threads that wrote
  // them, in a fixed tree: at each level, row r takes in row r + half.
  int top = 1;
  while (top < R) top *= 2;
  for (int round = 0; round < 2; ++round) {
    __syncthreads();   // the plane is free
    float* pa = plane + r * C + q * VEC;
    float* pb = plane + (R + r) * C + q * VEC;
    if (active) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        pa[j] = round ? t1[j] : s1[j];
        pb[j] = round ? t2[j] : s2[j];
      }
    }
    __syncthreads();
    for (int half = top / 2; half >= 1; half /= 2) {
      if (active && r < half && r + half < R) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          pa[j] += pa[half * C + j];
          pb[j] += pb[half * C + j];
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < 2 * G; e += THREADS) {
      const int which = e / G;
      const int g = e - which * G;
      const float* row0 = plane + which * R * C + g * cg_size;
      float a = 0.f;
      for (int c = 0; c < cg_size; ++c) a += row0[c];
      gsum[(2 * round + which) * G + g] = a;
    }
  }

  // Over the cluster, in rank order: every block gets the same totals.
  cluster.sync();
  float* gtot = gstat;   // totals first, then the statistics in place
  for (int e = tid; e < 4 * G; e += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < nblk) a += cluster.map_shared_rank(gsum, k)[e];
    }
    gtot[e] = a;
  }
  if (nblk > 1) cluster_arrive();   // done reading the others' sums
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    const float d = gtot[g] / count;                 // mean of x - K
    const float var = fmaxf(gtot[G + g] / count - d * d, 0.f);
    const float m1 = gtot[2 * G + g] / count;
    const float cov = gtot[3 * G + g] / count - d * m1;   // mean((x-mu) dx)
    const float rstd = rsqrtf(var + eps);
    gtot[g] = gshift[g] + d;                          // mu
    gtot[G + g] = rstd;
    gtot[2 * G + g] = m1;
    gtot[3 * G + g] = rstd * cov;                     // m2 = mean(xh dx)
  }
  __syncthreads();

  // Output pass: dy = act'(z) (A dx + Bc (x - mu) + Cc), z = A (x - mu) + bias.
  float mu[VEC], a[VEC], b[VEC], bc[VEC], cc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int ch = active ? q * VEC + j : 0;
    const int g = ch / cg_size;
    const float rstd = gstat[G + g];
    mu[j] = gstat[g];
    a[j] = rstd * scale[ch];
    b[j] = bias[ch];
    bc[j] = rstd * ((dscale ? dscale[ch] : 0.f) - a[j] * gstat[3 * G + g]);
    cc[j] = (dbias ? dbias[ch] : 0.f) - a[j] * gstat[2 * G + g];
  }
  sweep(on_chip, false, [&](int k, const T* sx, const T* sdx) {
    if (!active) return;
    const V* vx = reinterpret_cast<const V*>(sx);
    const V* vdx = reinterpret_cast<const V*>(sdx);
    V* out = reinterpret_cast<V*>(dys + int64_t(k) * chunk_rows * row_elems);
    const int n = chunk_len(k);
    for (int row = r; row < n; row += R) {
      const V xv = vx[row * tpp + q];
      const V dv = vdx[row * tpp + q];
      V o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = to_float(xv.v[j]) - mu[j];
        const float z = fmaf(d, a[j], b[j]);
        float t = fmaf(a[j], to_float(dv.v[j]), fmaf(bc[j], d, cc[j]));
        if (act == 1) {
          const float sg = __fdividef(1.f, 1.f + __expf(-z));
          t *= sg * (1.f + z * (1.f - sg));
        } else if (act == 2) {
          t *= z > 0.f ? 1.f : __expf(z);
        }
        o.v[j] = from_float<T>(t);
      }
      out[row * tpp + q] = o;
    }
  });
  // No block leaves while another still reads its sums.
  if (nblk > 1) cluster_wait();
}

template <typename T, int VEC>
int launch(const void* x, const void* dx, const float* scale,
           const float* bias, const float* dscale, const float* dbias,
           void* dy, int B, int P, int C, int G, int act, float eps,
           int cluster, int rows, int chunk_rows, int stages, int smem_bytes,
           cudaStream_t s) {
  auto kernel = groupnorm_act_jvp_kernel<T, VEC>;
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
  cfg.numAttrs = cluster > 1 ? 1 : 0;   // one block an image: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(dx),
      scale, bias, dscale, dbias, static_cast<T*>(dy), P, C, G, act, eps,
      rows, chunk_rows, stages);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dx and dy share it; scale, bias,
// dscale and dbias are float32, dscale and dbias null for a zero tangent).
// The plan (blocks an image, pixels a block, pixels a chunk, ring stages,
// vector width and shared-memory bytes) comes from ops/groupnorm.py
// `jvp_plan`; vec > 1 needs 16-byte aligned tensors.  Returns
// cudaGetLastError() after the launch (0 on success), or the error of a
// refused launch.
extern "C" int groupnorm_act_jvp_nhwc(const void* x, const void* dx,
                                      const void* scale, const void* bias,
                                      const void* dscale, const void* dbias,
                                      void* dy, int B, int HW, int C, int G,
                                      int act, float eps, int dtype,
                                      int cluster, int vec, int rows,
                                      int chunk_rows, int stages,
                                      int smem_bytes, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int tpp = vec > 0 ? C / vec : 0;
  const int Q = tpp < THREADS ? tpp : THREADS;
  const int R = Q > 0 ? THREADS / Q : 0;
  const int64_t stage_bytes = round_up(chunk_rows * C * itemsize, 128);
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || act < 0 ||
      act > 2 || dtype < 0 || dtype > 1 || cluster < 1 ||
      cluster > MAX_CLUSTER || (vec != 1 && vec * itemsize != 16) ||
      C % vec != 0 || tpp > THREADS || rows < 1 ||
      int64_t(rows) * cluster < HW || int64_t(rows) * (cluster - 1) >= HW ||
      chunk_rows < 1 || chunk_rows > rows || stages < 1 ||
      stages > MAX_STAGES || smem_bytes > SMEM_LIMIT ||
      smem_bytes < head_bytes(R, C, G) + 2 * stages * stage_bytes ||
      (vec > 1 && (reinterpret_cast<uintptr_t>(x) |
                   reinterpret_cast<uintptr_t>(dx) |
                   reinterpret_cast<uintptr_t>(dy)) % 16)) {
    return int(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* dsc = static_cast<const float*>(dscale);
  const float* dbi = static_cast<const float*>(dbias);
  if (dtype == 0) {
    return vec == 4
        ? launch<float, 4>(x, dx, sc, bi, dsc, dbi, dy, B, HW, C, G, act, eps,
                           cluster, rows, chunk_rows, stages, smem_bytes, s)
        : launch<float, 1>(x, dx, sc, bi, dsc, dbi, dy, B, HW, C, G, act, eps,
                           cluster, rows, chunk_rows, stages, smem_bytes, s);
  }
  return vec == 8
      ? launch<__nv_bfloat16, 8>(x, dx, sc, bi, dsc, dbi, dy, B, HW, C, G, act,
                                 eps, cluster, rows, chunk_rows, stages,
                                 smem_bytes, s)
      : launch<__nv_bfloat16, 1>(x, dx, sc, bi, dsc, dbi, dy, B, HW, C, G, act,
                                 eps, cluster, rows, chunk_rows, stages,
                                 smem_bytes, s);
}
