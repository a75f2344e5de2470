// The two input gradients of the FlowNet cost volume at stride 1, NHWC
// float32.  With the forward
//
//   out[b, y, x, k] = (1/C) sum_c f1[b, y, x, c] * f2[b, y+dy_k, x+dx_k, c],
//   k = (dy+3)*7 + (dx+3), (dy, dx) in [-3, 3]^2, f2 zero outside the image,
//
// and a cotangent d (B, H, W, 49), the two entry points compute
//
//   df1 = B1(d, g)[b, y, x, c] = (1/C) sum_k d[b, y, x, k] * g[b, y+dy_k, x+dx_k, c]
//   df2 = B2(d, h)[b, y, x, c] = (1/C) sum_k d[b, y-dy_k, x-dx_k, k] * h[b, y-dy_k, x-dx_k, c]
//
// (g = f2 and h = f1 for the forward's gradients), every term whose source
// pixel lies outside the image zero.  ops/correlation.py builds every
// derivative of the cost volume, of any order, from these two and the
// forward (csrc/correlation.cu): the three maps are bilinear and close
// under differentiation.
//
// Replaces the gradient of the TPU kernel `correlation_pallas`
// (b_pinn_kalman_filter_tpu/ops/correlation_pallas.py:42, pallas_call :52).
// The Pallas kernel has no backward of its own: JAX differentiates the XLA
// `correlation` (ops/correlation.py:29) around it.
//
// What bounds it on an H100: bytes.  A pixel takes 98 C operations against
// (49 + 2 C) * 4 bytes, 5 to 10 operations a byte at C = 16..128, under the
// card's f32 balance point of 20.  At the FlowNet's levels a call moves 0.3
// to 21 MB, so the small levels are bounded by latency and the launch.
//
// Design (ops/correlation.py `correlation_bwd_plan` sizes it; K3's own
// design, csrc/correlation.cu, is the model):
// - A block owns a th x tw tile that divides the image exactly (no pixel
//   outside it is computed) and cs channels of one image; the plan cuts the
//   tile or splits the channels until the grid covers the card's 132 SMs,
//   choosing among the tilings the one that moves the fewest bytes.
//   Channels are independent, so a split needs no cluster and no sum
//   across blocks.
// - Register blocking: a thread owns a strip of S pixels along x and one
//   4-channel vector.  For each dy it slides over the S + 6 vectors of g (h)
//   in its row of the halo, each feeding up to 7 shifts x S pixels x 4
//   FMAs, with the coefficients of d in registers (8 floats a 16-byte pair
//   of shared loads).  Lanes of one strip read the same d (a broadcast),
//   consecutive lanes consecutive vectors of g.
// - Staging: g (h) with its 3-pixel halo, channels as 16-byte vectors
//   copied by cp.async where C is a multiple of 4 (4 bytes a copy
//   otherwise, vectors past C zero: C = 1 and C = 3 work as C = 4), zero
//   outside the image; one spare column every S keeps a quarter warp's
//   strips on distinct banks.  d by 4-byte cp.async into the tile's pixels,
//   49 values a pixel as 7 rows of 8: B1 d at the pixel itself (the tile's
//   rows, coalesced), B2 d[p - s_k, k] gathered into p's slot, zero
//   outside the image, so that B1 and B2 share one compute loop and each
//   value of d a block needs is read once.  The staging loops walk rows and
//   columns without a division by a runtime size, which costs tens of
//   instructions an element against one copy.
// - Each output is written once, summed over the 49 shifts in a fixed
//   order in float, with no atomics: the same bits every run.  The sum is
//   divided by C at the end, as the forward's mean is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 3;                 // maximum displacement
constexpr int K = 2 * D + 1;         // shifts along one axis
constexpr int SHIFTS = K * K;
constexpr int DROW = 8;              // a dy row of d's coefficients, padded
constexpr int DPIX = K * DROW;       // floats of d a staged pixel
constexpr int MAX_THREADS = 256;
constexpr int MAX_GRID = 65535;
constexpr int SMEM_LIMIT = 232448;   // the H100's 227 KB a block

// Padded shared-memory column of halo column x: one spare after every
// `strip` columns.
__host__ __device__ __forceinline__ int pad_col(int x, int strip) {
  return strip > 1 ? x + x / strip : x;
}

struct Geometry {
  int hw;        // padded halo row (pixels)
  int halo;      // halo pixels (padded)
  int nv;        // 4-channel vectors a block
};

__host__ __device__ __forceinline__ Geometry geometry(int th, int tw,
                                                      int strip, int cs) {
  Geometry g;
  g.hw = pad_col(tw + 2 * D - 1, strip) + 1;
  g.halo = (th + 2 * D) * g.hw;
  g.nv = (cs + 3) / 4;
  return g;
}

// g (h) over the halo as 16-byte vectors, d at the tile's pixels.
__host__ __device__ __forceinline__ int64_t smem_bytes(int th, int tw,
                                                       int strip, int cs) {
  const Geometry g = geometry(th, tw, strip, cs);
  return int64_t(g.halo) * g.nv * 16 + int64_t(th) * tw * DPIX * 4;
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

__device__ __forceinline__ void fma4(float4& acc, float w, float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// kSource false: B1 (d at the output pixel, g at p + s_k);
// kSource true:  B2 (d and h both at the source pixel p - s_k).
// Grid (tiles, channel splits, batch); blockDim th * (tw / S) * nv.
template <bool kSource, int S, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS) correlation_bwd_kernel(
    const float* __restrict__ d, const float* __restrict__ g,
    float* __restrict__ out, int B, int H, int W, int C, int th, int tw,
    int cs) {
  const Geometry geo = geometry(th, tw, S, cs);
  extern __shared__ float4 smem[];
  float4* sg = smem;                                         // [halo][nv]
  float* sd = reinterpret_cast<float*>(smem + geo.halo * geo.nv);  // [th*tw][56]

  const int tiles_x = W / tw;
  const int y0 = int(blockIdx.x) / tiles_x * th;
  const int x0 = int(blockIdx.x) % tiles_x * tw;
  const int c0 = int(blockIdx.y) * cs;
  const int cn = min(cs, C - c0);
  const int nv = geo.nv;
  const int strips = tw / S;
  const int cv = threadIdx.x % nv;
  const int strip = threadIdx.x / nv;
  const int ty = strip / strips;
  const int sx = strip % strips * S;
  const int nthreads = th * strips * nv;
  // The g-staging walk over the halo's pixels: start at pixel `strip`,
  // step by the block's strip count.
  const int nstrips = th * strips;
  const int walk_row0 = strip / (tw + 2 * D);
  const int walk_col0 = strip - walk_row0 * (tw + 2 * D);
  const int walk_drow = nstrips / (tw + 2 * D);
  const int walk_dcol = nstrips - walk_drow * (tw + 2 * D);

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* db = d + int64_t(b) * H * W * SHIFTS;
    const float* gb = g + int64_t(b) * H * W * C;

    // g (h) over the tile and its halo, zero outside the image and past C:
    // thread (strip, cv) copies vector cv of halo pixels strip, strip +
    // nstrips, ..., walking rows and columns without a division.
    const int hwid = tw + 2 * D;
    {
      int hr = walk_row0, hc = walk_col0;
      for (; hr < th + 2 * D;) {
        const int y = y0 - D + hr;
        const int x = x0 - D + hc;
        const bool inside = y >= 0 && y < H && x >= 0 && x < W;
        const float* src = gb + (int64_t(y) * W + x) * C + c0 + 4 * cv;
        float4* dst = sg + (hr * geo.hw + pad_col(hc, S)) * nv + cv;
        if (VEC) {
          cp_async16(dst, inside ? src : gb, inside);
        } else {
          float* t = reinterpret_cast<float*>(dst);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = inside && 4 * cv + j < cn;
            cp_async4(t + j, ok ? src + j : gb, ok);
          }
        }
        hr += walk_drow;
        hc += walk_dcol;
        if (hc >= hwid) {
          hc -= hwid;
          ++hr;
        }
      }
    }
    // d at the tile's pixels, as 7 rows of 8 a pixel.  B1 reads d at the
    // output pixel: a row of the tile is one run of 49-float pixels in
    // device memory, read coalesced.  B2 reads d[p - s_k, k]: gathered into
    // p's slot (4-byte reads of nearby rows, which the L1 cache shares),
    // zero where the source lies outside the image.  Either way each value
    // of d a block needs is read once, and the two compute loops match.
    for (int ty2 = 0; ty2 < th; ++ty2) {
      for (int e = threadIdx.x; e < tw * SHIFTS; e += nthreads) {
        const int tx = e / SHIFTS;
        const int k = e - tx * SHIFTS;
        const int dyi = k / K;
        const int dxi = k - dyi * K;
        int y = y0 + ty2;
        int x = x0 + tx;
        if (kSource) {
          y -= dyi - D;
          x -= dxi - D;
        }
        const bool inside = y >= 0 && y < H && x >= 0 && x < W;
        cp_async4(sd + (ty2 * tw + tx) * DPIX + dyi * DROW + dxi,
                  inside ? db + (int64_t(y) * W + x) * SHIFTS + k : db,
                  inside);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    float4 acc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int dyi = 0; dyi < K; ++dyi) {
      // Halo row of g (h): B1 ty + dy + D, B2 ty - dy + D.
      const int hr = kSource ? ty + 2 * D - dyi : ty + dyi;
      const float4* grow = sg + hr * geo.hw * nv + cv;
      float w[S][DROW];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const float4* p = reinterpret_cast<const float4*>(
            sd + (ty * tw + sx + i) * DPIX + dyi * DROW);
        const float4 lo = p[0], hi = p[1];
        w[i][0] = lo.x; w[i][1] = lo.y; w[i][2] = lo.z; w[i][3] = lo.w;
        w[i][4] = hi.x; w[i][5] = hi.y; w[i][6] = hi.z; w[i][7] = hi.w;
      }
#pragma unroll
      for (int h = 0; h < S + 2 * D; ++h) {
        const float4 v = grow[pad_col(sx + h, S) * nv];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          // B1: g at x_i + dx, halo column sx + i + dx + D; B2: h at
          // x_i - dx, halo column sx + i - dx + D.
          const int dxi = kSource ? i + 2 * D - h : h - i;
          if (dxi >= 0 && dxi < K) fma4(acc[i], w[i][dxi], v);
        }
      }
    }

    const float inv = 1.f / float(C);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int64_t o = ((int64_t(b) * H + y0 + ty) * W + x0 + sx + i) * C +
                        c0 + 4 * cv;
      const float4 a = make_float4(acc[i].x * inv, acc[i].y * inv,
                                   acc[i].z * inv, acc[i].w * inv);
      if (VEC) {
        *reinterpret_cast<float4*>(out + o) = a;
      } else {
        const float v4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * cv + j < cn) out[o + j] = v4[j];
        }
      }
    }
    __syncthreads();   // the next image overwrites the staged tiles
  }
}

template <bool kSource, int S, bool VEC>
int launch(const float* d, const float* g, float* out, int B, int H, int W,
           int C, int th, int tw, int split, int cs, int smem,
           cudaStream_t s) {
  auto kernel = correlation_bwd_kernel<kSource, S, VEC>;
  static bool smem_set = false;    // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return int(err);
    smem_set = true;
  }
  const dim3 grid(unsigned((H / th) * (W / tw)), unsigned(split),
                  unsigned(B < MAX_GRID ? B : MAX_GRID));
  const int threads = th * (tw / S) * ((cs + 3) / 4);
  kernel<<<grid, threads, smem, s>>>(d, g, out, B, H, W, C, th, tw, cs);
  return int(cudaGetLastError());
}

template <bool kSource, bool VEC>
int launch_strip(int strip, const float* d, const float* g, float* out,
                 int B, int H, int W, int C, int th, int tw, int split,
                 int cs, int smem, cudaStream_t s) {
  switch (strip) {
    case 4:
      return launch<kSource, 4, VEC>(d, g, out, B, H, W, C, th, tw, split,
                                     cs, smem, s);
    case 2:
      return launch<kSource, 2, VEC>(d, g, out, B, H, W, C, th, tw, split,
                                     cs, smem, s);
    default:
      return launch<kSource, 1, VEC>(d, g, out, B, H, W, C, th, tw, split,
                                     cs, smem, s);
  }
}

template <bool kSource>
int entry(const void* d, const void* g, void* out, int B, int H, int W, int C,
          int th, int tw, int strip, int split, int cs, int vec,
          void* stream) {
  const int64_t smem = smem_bytes(th, tw, strip, cs);
  const int64_t threads = int64_t(th) * (tw > 0 && strip > 0 ? tw / strip : 0)
                          * ((cs + 3) / 4);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || th <= 0 || tw <= 0 ||
      H % th || W % tw || (strip != 1 && strip != 2 && strip != 4) ||
      tw % strip || split < 1 || cs <= 0 || int64_t(cs) * split < C ||
      int64_t(cs) * (split - 1) >= C || (split > 1 && cs % 4) ||
      threads < 1 || threads > MAX_THREADS || smem > SMEM_LIMIT ||
      int64_t(H / th) * (W / tw) > MAX_GRID || split > MAX_GRID ||
      (vec && (C % 4 || (reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(out)) % 16))) {
    return int(cudaErrorInvalidValue);
  }
  const float* a = static_cast<const float*>(d);
  const float* b = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_strip<kSource, true>(strip, a, b, o, B, H, W, C, th, tw,
                                           split, cs, int(smem), s)
             : launch_strip<kSource, false>(strip, a, b, o, B, H, W, C, th,
                                            tw, split, cs, int(smem), s);
}

}  // namespace

// d (B, H, W, 49), g (B, H, W, C) float32 contiguous; out (B, H, W, C)
// float32.  The plan (tile th x tw, strip, channel split and channels a
// block cs, vec) is ops/correlation.py `correlation_bwd_plan`'s; vec = 1
// takes 16-byte copies (C a multiple of 4, 16-byte aligned g and out).
// Each returns cudaGetLastError() after the launch (0 on success), or the
// error of a refused launch.
extern "C" int correlation_df1_f32(const void* d, const void* g, void* out,
                                   int B, int H, int W, int C, int th, int tw,
                                   int strip, int split, int cs, int vec,
                                   void* stream) {
  return entry<false>(d, g, out, B, H, W, C, th, tw, strip, split, cs, vec,
                      stream);
}

extern "C" int correlation_df2_f32(const void* d, const void* h, void* out,
                                   int B, int H, int W, int C, int th, int tw,
                                   int strip, int split, int cs, int vec,
                                   void* stream) {
  return entry<true>(d, h, out, B, H, W, C, th, tw, strip, split, cs, vec,
                     stream);
}
