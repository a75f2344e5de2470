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
// What bounds it on an H100: a pixel takes 98 C operations against
// (49 + 2 C) * 4 bytes, 5 to 10 operations a byte at C = 16..128, under
// the card's f32 balance point of 20: bytes.
// At the FlowNet's levels a call moves 0.3 to 21 MB, so the small levels
// are bounded by the launch.
//
// Design (simple and right first).  Both are gathers: each output element
// is written once, by one thread, as a sum over the 49 shifts in a fixed
// order, so a result does not depend on scheduling (no atomics).  One block
// per (8 x 8 pixel tile, image, chunk of up to 32 channels).  The block
// stages in shared memory the 64 x 49 values of d its pixels read (B1: d at
// the pixel itself; B2: d[p - s_k, k], gathered from the shifted pixels)
// and the tile's g (h) with a 3-pixel halo, 14 x 14 pixels, zero outside
// the image and past C.  Consecutive threads take consecutive channels of
// one pixel: a warp reads one d row by broadcast and consecutive banks of
// the halo (channel stride 33).  The sum is divided by C at the end, as
// the forward's mean is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 3;                 // maximum displacement
constexpr int SIDE = 2 * D + 1;
constexpr int SHIFTS = SIDE * SIDE;
constexpr int TH = 8;                // tile rows
constexpr int TW = 8;                // tile columns
constexpr int NPIX = TH * TW;
constexpr int HH = TH + 2 * D;       // halo rows
constexpr int HW = TW + 2 * D;       // halo columns
constexpr int CC = 32;               // channels per block
constexpr int CS = CC + 1;           // channel stride in shared memory
constexpr int THREADS = 256;
constexpr int MAX_GRID_Z = 65535;

// kSource false: B1 (d at the output pixel, g at p + s_k);
// kSource true:  B2 (d and h both at the source pixel p - s_k).
template <bool kSource>
__global__ void __launch_bounds__(THREADS) correlation_bwd_kernel(
    const float* __restrict__ d, const float* __restrict__ g,
    float* __restrict__ out, int B, int H, int W, int C, int chunks) {
  __shared__ float sd[NPIX * SHIFTS];
  __shared__ float sg[HH * HW * CS];
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;

  for (int z = blockIdx.z; z < B * chunks; z += gridDim.z) {
    const int b = z / chunks;
    const int c0 = (z - b * chunks) * CC;
    const int cn = C - c0 < CC ? C - c0 : CC;
    const float* db = d + int64_t(b) * H * W * SHIFTS;
    const float* gb = g + int64_t(b) * H * W * C;

    for (int e = threadIdx.x; e < NPIX * SHIFTS; e += THREADS) {
      const int pix = e / SHIFTS;
      const int k = e - pix * SHIFTS;
      int y = y0 + pix / TW;
      int x = x0 + pix % TW;
      if (kSource) {
        y -= k / SIDE - D;
        x -= k % SIDE - D;
      }
      float val = 0.f;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        val = db[(int64_t(y) * W + x) * SHIFTS + k];
      }
      sd[e] = val;
    }
    for (int e = threadIdx.x; e < HH * HW * cn; e += THREADS) {
      const int q = e / cn;
      const int c = e - q * cn;
      const int y = y0 - D + q / HW;
      const int x = x0 - D + q % HW;
      float val = 0.f;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        val = gb[(int64_t(y) * W + x) * C + c0 + c];
      }
      sg[q * CS + c] = val;
    }
    __syncthreads();

    const float count = float(C);
    for (int e = threadIdx.x; e < NPIX * cn; e += THREADS) {
      const int pix = e / cn;
      const int c = e - pix * cn;
      const int ty = pix / TW;
      const int tx = pix - ty * TW;
      const int y = y0 + ty;
      const int x = x0 + tx;
      if (y >= H || x >= W) continue;
      const float* dp = sd + pix * SHIFTS;
      // The halo's origin is (y0 - D, x0 - D).  Shift (dy, dx) = (i - D,
      // j - D): B1 reads g at (ty + dy, tx + dx), halo cell (ty + i,
      // tx + j); B2 reads h at (ty - dy, tx - dx), halo cell
      // (ty + 2D - i, tx + 2D - j).
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SIDE; ++i) {
        const int hy = kSource ? ty + 2 * D - i : ty + i;
#pragma unroll
        for (int j = 0; j < SIDE; ++j) {
          const int hx = kSource ? tx + 2 * D - j : tx + j;
          acc = fmaf(dp[i * SIDE + j], sg[(hy * HW + hx) * CS + c], acc);
        }
      }
      out[((int64_t(b) * H + y) * W + x) * C + c0 + c] = acc / count;
    }
    __syncthreads();   // the next (image, chunk) overwrites the staged tiles
  }
}

template <bool kSource>
int launch(const void* d, const void* g, void* out, int B, int H, int W,
           int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  const int chunks = (C + CC - 1) / CC;
  const int z = B * chunks;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH,
                  z < MAX_GRID_Z ? z : MAX_GRID_Z);
  correlation_bwd_kernel<kSource>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(d), static_cast<const float*>(g),
          static_cast<float*>(out), B, H, W, C, chunks);
  return int(cudaGetLastError());
}

}  // namespace

// d (B, H, W, 49), g (B, H, W, C) float32 contiguous; out (B, H, W, C)
// float32.  Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int correlation_df1_f32(const void* d, const void* g, void* out,
                                   int B, int H, int W, int C, void* stream) {
  return launch<false>(d, g, out, B, H, W, C, stream);
}

extern "C" int correlation_df2_f32(const void* d, const void* h, void* out,
                                   int B, int H, int W, int C, void* stream) {
  return launch<true>(d, h, out, B, H, W, C, stream);
}
