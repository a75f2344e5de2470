// FlowNet cost volume at stride 1, NHWC float32:
//   out[b, y, x, (dy+3)*7 + (dx+3)] = mean_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]
// for (dy, dx) in [-3, 3]^2, with f2 zero outside the image.
//
// Replaces the TPU kernel `correlation_pallas`
// (b_pinn_kalman_filter_tpu/ops/correlation_pallas.py:42, pallas_call :52,
// body `_corr_kernel` :28), which keeps one whole image of f1 and the
// zero-padded f2 in VMEM per grid step.
//
// What bounds it on an H100: bytes in principle (98 C operations per pixel
// against 8 C + 196 bytes, under the card's f32 balance point), but at the
// FlowNet's levels (32x32x16 down to 2x2x128, 8 posterior draws folded into
// the batch) the bound is a microsecond or less, so what a design loses is
// parallelism and latency: too few blocks for 132 SMs, shared loads per
// FMA, and the chain of dependent steps inside a block.
//
// Design.  The plan (ops/correlation.py `correlation_plan`) gives a block a
// tile of th x tw pixels of one image that divides the image exactly (no
// pixel outside it is computed), threads 7 * th * tw / STRIP, and splits
// the channels over a thread-block cluster of `split` blocks where the
// level has too few tiles to spread over the card.
// - Register blocking: a thread owns a strip of STRIP pixels along x, one
//   dy and all seven dx.  For each 4-channel vector it loads its STRIP f1
//   vectors and slides over the STRIP + 6 f2 vectors of its row of the
//   window, one at a time, each feeding up to 7 x 4 FMAs: (2 STRIP + 6)
//   16-byte shared loads per 28 STRIP FMAs (0.125 at STRIP 4, 0.29 at 1).
// - Shared memory holds channels as 16-byte vectors, plane by plane
//   ([vector][row][column]), the f2 window with its 3-pixel halo; one
//   column of padding every STRIP columns puts the 8 threads of a quarter
//   warp on 8 distinct 16-byte bank groups.  Vectors past C are zeros, so
//   C = 3 or C = 1 work as C = 4.
// - Staging is cp.async, 16 bytes a copy where C is a multiple of 4 (4
//   bytes a copy otherwise), zero-filled outside the image, in chunks of 16
//   channels, double-buffered where a block has more than one chunk.
// - A thread's sums run in double (see dot4); it leaves its 7 STRIP sums,
//   rounded to float, in shared memory; the block then
//   writes its tile's outputs as one coalesced run (16-byte stores where
//   the tile spans whole rows), each block of a cluster a share of them,
//   summing the cluster's partial sums through distributed shared memory
//   in rank order: one launch, no atomics, the same bits every run.  The
//   sum is scaled by 1 / C at the end: the reference's mean, to within a
//   rounding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 3;                 // maximum displacement
constexpr int K = 2 * D + 1;         // shifts along one axis
constexpr int SHIFTS = K * K;
constexpr int CHUNK_VECS = 4;        // 16 channels a stage
constexpr int MAX_THREADS = 256;
constexpr int MAX_SPLIT = 8;         // portable cluster size
constexpr int MAX_GRID_Z = 65535;
constexpr int SMEM_LIMIT = 232448;   // the H100's 227 KB a block

// Padded shared-memory column of window column x: one spare vector after
// every `strip` columns.
__host__ __device__ __forceinline__ int pad_col(int x, int strip) {
  return strip > 1 ? x + x / strip : x;
}

struct Geometry {
  int w1, w2;            // padded row widths (vectors) of the f1 and f2 planes
  int plane1, plane2;    // vectors a plane
  int stage;             // vectors a stage: CHUNK_VECS planes of each
};

__host__ __device__ __forceinline__ Geometry geometry(int th, int tw,
                                                      int strip) {
  Geometry g;
  g.w1 = pad_col(tw - 1, strip) + 1;
  g.w2 = pad_col(tw + 2 * D - 1, strip) + 1;
  g.plane1 = th * g.w1;
  g.plane2 = (th + 2 * D) * g.w2;
  g.stage = CHUNK_VECS * (g.plane1 + g.plane2);
  return g;
}

__host__ __device__ __forceinline__ int64_t smem_bytes(int th, int tw,
                                                       int strip, int stages) {
  return int64_t(stages) * geometry(th, tw, strip).stage * 16 +
         int64_t(th) * tw * SHIFTS * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = unsigned(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` x `cols` pixels of channels [c, c + cn) of one image, whose
// top-left pixel is (y0, x0), into the first ceil(cn / 4) of CHUNK_VECS
// planes of `plane` vectors with padded rows of `w` vectors; zeros outside
// the image and past c + cn.  A thread copies a pixel's vectors one after
// another, so a warp reads whole runs of consecutive pixels.
template <bool VEC>
__device__ __forceinline__ void stage_planes(
    float4* dst, const float* img, int H, int W, int C, int y0, int x0,
    int rows, int cols, int c, int cn, int w, int plane, int strip) {
  const int n = rows * cols;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int row = q / cols;
    const int col = q - row * cols;
    const int y = y0 + row;
    const int x = x0 + col;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    const float* src = inside ? img + (int64_t(y) * W + x) * C + c : img;
    float4* to = dst + row * w + pad_col(col, strip);
#pragma unroll
    for (int v = 0; v < CHUNK_VECS; ++v) {
      if (4 * v >= cn) break;
      if (VEC) {
        cp_async16(to + v * plane, inside ? src + 4 * v : img, inside);
      } else {
        float* t = reinterpret_cast<float*>(to + v * plane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = inside && 4 * v + j < cn;
          cp_async4(t + j, ok ? src + 4 * v + j : img, ok);
        }
      }
    }
  }
}

// The sums run in double: a product of two floats is exact in double, so
// a sum over C channels keeps its precision whatever its cancellation.  A
// sequential float sum loses up to ~C ulps of the terms' magnitudes, and
// the PINN residual's third-order parameter gradient, which calls this
// kernel from the backwards of csrc/correlation_bwd.cu's maps, magnifies
// that about a thousandfold: with float sums the kernel path's residual
// gradient was 1.0e-4 of the largest leaf's away from the plain path's,
// with double sums 8.8e-6 (chip_smoke.py's phase-2 check at batch 64 on
// an H100).  The double pipe's lower rate costs little here: the levels
// are bounded by latency and the launch, not by the FMAs.
__device__ __forceinline__ double dot4(float4 a, float4 b, double acc) {
  acc = fma(double(a.x), double(b.x), acc);
  acc = fma(double(a.y), double(b.y), acc);
  acc = fma(double(a.z), double(b.z), acc);
  return fma(double(a.w), double(b.w), acc);
}

// Grid (split, tiles, batch); a cluster is the `split` blocks of one tile,
// block rank r owning channels [r * cs, min(C, (r + 1) * cs)).
template <int STRIP, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1) correlation_kernel(
    const float* __restrict__ f1, const float* __restrict__ f2,
    float* __restrict__ out, int B, int H, int W, int C, int th, int tw,
    int cs, int stages) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const Geometry g = geometry(th, tw, STRIP);
  extern __shared__ float4 smem[];
  float* part = reinterpret_cast<float*>(smem + stages * g.stage);

  const int S = tw / STRIP;                     // strips a row
  const int tiles_x = W / tw;
  const int y0 = int(blockIdx.y) / tiles_x * th;
  const int x0 = int(blockIdx.y) % tiles_x * tw;
  const int s = threadIdx.x % S;
  const int r = threadIdx.x / S % th;
  const int dyi = threadIdx.x / (S * th);      // dy + 3, in [0, 7)
  const int c_lo = rank * cs;
  const int c_hi = min(C, c_lo + cs);
  const int chunk = 4 * CHUNK_VECS;
  const int nchunks = (c_hi - c_lo + chunk - 1) / chunk;
  // Where this thread's f1 strip and f2 window row start in a plane.
  const int off1 = r * g.w1 + pad_col(s * STRIP, STRIP);
  const int off2 = (r + dyi) * g.w2 + pad_col(s * STRIP, STRIP);

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* f1b = f1 + int64_t(b) * H * W * C;
    const float* f2b = f2 + int64_t(b) * H * W * C;
    auto stage = [&](int k) {
      float4* buf = smem + (k % stages) * g.stage;
      const int c = c_lo + k * chunk;
      const int cn = min(chunk, c_hi - c);
      stage_planes<VEC>(buf, f2b, H, W, C, y0 - D, x0 - D, th + 2 * D,
                        tw + 2 * D, c, cn, g.w2, g.plane2, STRIP);
      stage_planes<VEC>(buf + CHUNK_VECS * g.plane2, f1b, H, W, C, y0, x0,
                        th, tw, c, cn, g.w1, g.plane1, STRIP);
      cp_async_commit();
    };

    double acc[STRIP][K];
#pragma unroll
    for (int k = 0; k < STRIP; ++k) {
#pragma unroll
      for (int dx = 0; dx < K; ++dx) acc[k][dx] = 0.0;
    }

    stage(0);
    for (int k = 0; k < nchunks; ++k) {
      if (k + 1 < nchunks) {           // the plan gives 2 stages here
        stage(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float4* buf = smem + (k % stages) * g.stage;
      const float4* p2 = buf + off2;
      const float4* p1 = buf + CHUNK_VECS * g.plane2 + off1;
      const int nv = (min(chunk, c_hi - c_lo - k * chunk) + 3) / 4;
      for (int v = 0; v < nv; ++v) {
        float4 a[STRIP];
#pragma unroll
        for (int i = 0; i < STRIP; ++i) a[i] = p1[v * g.plane1 + i];
#pragma unroll
        for (int j = 0; j < STRIP + 2 * D; ++j) {
          const float4 w = p2[v * g.plane2 + j + (STRIP > 1 ? j / STRIP : 0)];
#pragma unroll
          for (int i = 0; i < STRIP; ++i) {
            const int dx = j - i;
            if (dx >= 0 && dx < K) acc[i][dx] = dot4(a[i], w, acc[i][dx]);
          }
        }
      }
      __syncthreads();   // stage k + 2 reuses this buffer
    }

#pragma unroll
    for (int i = 0; i < STRIP; ++i) {
      float* to = part + (r * tw + s * STRIP + i) * SHIFTS + dyi * K;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) to[dx] = float(acc[i][dx]);
    }
    cluster.sync();    // also the block barrier for a cluster of one

    // The tile's outputs: one run of th * tw * 49 floats where the tile
    // spans whole rows (every level of the FlowNet), written 16 bytes at a
    // time where the run is aligned, each rank a share.
    const int n_out = th * tw * SHIFTS;
    const int64_t first = ((int64_t(b) * H + y0) * W + x0) * SHIFTS;
    const float inv = 1.f / float(C);
    if (tw == W && n_out % 4 == 0 && first % 4 == 0) {
      const int n4 = n_out / 4;
      const int share = (n4 + split - 1) / split;
      const int o_end = min(n4, (rank + 1) * share);
      float4* to = reinterpret_cast<float4*>(out + first);
      for (int o = rank * share + threadIdx.x; o < o_end; o += blockDim.x) {
        float4 sum = reinterpret_cast<const float4*>(part)[o];
        if (split > 1) {
          sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < MAX_SPLIT; ++k) {   // in rank order
            if (k < split) {
              const float4 p = reinterpret_cast<const float4*>(
                  cluster.map_shared_rank(part, k))[o];
              sum.x += p.x;
              sum.y += p.y;
              sum.z += p.z;
              sum.w += p.w;
            }
          }
        }
        to[o] = make_float4(sum.x * inv, sum.y * inv, sum.z * inv,
                            sum.w * inv);
      }
    } else {
      const int share = (n_out + split - 1) / split;
      const int o_end = min(n_out, (rank + 1) * share);
      for (int o = rank * share + threadIdx.x; o < o_end; o += blockDim.x) {
        float sum = part[o];
        if (split > 1) {
          sum = 0.f;
#pragma unroll
          for (int k = 0; k < MAX_SPLIT; ++k) {   // in rank order
            if (k < split) sum += cluster.map_shared_rank(part, k)[o];
          }
        }
        const int pix = o / SHIFTS;
        const int shift = o - pix * SHIFTS;
        const int y = y0 + pix / tw;
        const int x = x0 + pix % tw;
        out[((int64_t(b) * H + y) * W + x) * SHIFTS + shift] = sum * inv;
      }
    }
    // No block leaves, or overwrites its sums for the next image, while
    // another still reads them.
    cluster.sync();
  }
}

template <int STRIP, bool VEC>
int launch(const float* f1, const float* f2, float* out, int B, int H, int W,
           int C, int th, int tw, int split, int cs, int stages, int smem,
           cudaStream_t s) {
  auto kernel = correlation_kernel<STRIP, VEC>;
  static bool smem_set = false;    // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return int(err);
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(split), unsigned((H / th) * (W / tw)),
                     unsigned(B < MAX_GRID_Z ? B : MAX_GRID_Z));
  cfg.blockDim = dim3(unsigned(K * th * (tw / STRIP)));
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;    // one block a tile: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, f1, f2, out, B, H,
                                             W, C, th, tw, cs, stages);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <bool VEC>
int launch_strip(int strip, const float* f1, const float* f2, float* out,
                 int B, int H, int W, int C, int th, int tw, int split, int cs,
                 int stages, int smem, cudaStream_t s) {
  switch (strip) {
    case 4:
      return launch<4, VEC>(f1, f2, out, B, H, W, C, th, tw, split, cs,
                            stages, smem, s);
    case 2:
      return launch<2, VEC>(f1, f2, out, B, H, W, C, th, tw, split, cs,
                            stages, smem, s);
    default:
      return launch<1, VEC>(f1, f2, out, B, H, W, C, th, tw, split, cs,
                            stages, smem, s);
  }
}

}  // namespace

// f1, f2 (B, H, W, C) float32 contiguous; out (B, H, W, 49) float32.  The
// plan (tile th x tw, strip, cluster split, channels a rank cs, stages) is
// ops/correlation.py `correlation_plan`'s; vec = 1 takes 16-byte copies
// (C a multiple of 4, 16-byte aligned inputs).  Returns cudaGetLastError()
// after the launch (0 on success), or the error of a refused launch.
extern "C" int correlation_f32(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, int th, int tw,
                               int strip, int split, int cs, int stages,
                               int vec, void* stream) {
  const int64_t smem = smem_bytes(th, tw, strip, stages);
  const int chunk = 4 * CHUNK_VECS;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || th <= 0 || tw <= 0 ||
      H % th || W % tw || (strip != 1 && strip != 2 && strip != 4) ||
      tw % strip || K * th * (tw / strip) > MAX_THREADS || split < 1 ||
      split > MAX_SPLIT || cs <= 0 || int64_t(cs) * (split - 1) >= C ||
      int64_t(cs) * split < C || (split > 1 && cs % 4) ||
      stages < 1 || stages > 2 || (cs > chunk && stages < 2) ||
      smem > SMEM_LIMIT || int64_t(H / th) * (W / tw) > MAX_GRID_Z ||
      (vec && (C % 4 || (reinterpret_cast<uintptr_t>(f1) |
                         reinterpret_cast<uintptr_t>(f2)) % 16))) {
    return int(cudaErrorInvalidValue);
  }
  const float* a = static_cast<const float*>(f1);
  const float* b = static_cast<const float*>(f2);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_strip<true>(strip, a, b, o, B, H, W, C, th, tw, split,
                                  cs, stages, int(smem), s)
             : launch_strip<false>(strip, a, b, o, B, H, W, C, th, tw, split,
                                   cs, stages, int(smem), s);
}
