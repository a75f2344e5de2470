// FlowNet cost volume at stride 1, NHWC float32:
//   out[b, y, x, (dy+3)*7 + (dx+3)] = mean_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]
// for (dy, dx) in [-3, 3]^2, with f2 zero outside the image.
//
// Replaces the TPU kernel `correlation_pallas`
// (b_pinn_kalman_filter_tpu/ops/correlation_pallas.py:42, pallas_call :52,
// body `_corr_kernel` :28), which keeps one whole image of f1 and the
// zero-padded f2 in VMEM per grid step.
//
// What bounds it on an H100: at the FlowNet's shapes (C = 16..128, 49
// shifts) it does 98 C operations per pixel against 8 C + 196 bytes, 5 to
// 10 operations a byte, under the card's f32 balance point of 20: bytes.
// The pyramid's small levels (2x2 .. 32x32 at batch 1) are far too small to
// fill the card, so in practice a call is bounded by its launch and its
// latency.
//
// Design (simple and right first).  One block per (image, 8 x 8 pixel tile);
// the grid covers any H and W.  Channels go in chunks of 32: the block
// stages the tile's f1 vectors and the f2 window it needs, the tile plus a
// 3-pixel halo (14 x 14), in shared memory, writing zeros for f2 outside the
// image (the reference's zero padding) and for channels past C.  Each of the
// 256 threads owns up to 13 of the tile's 64 x 49 (pixel, shift) pairs and
// keeps their f32 sums in registers across the chunks; pairs are numbered
// pixel-major, so a warp reads one f1 vector by broadcast and writes 49
// consecutive outputs of a pixel.  A channel stride of 33 in shared memory
// keeps the shifted f2 reads on distinct banks.  The sum is divided by C at
// the end, as the reference's mean is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 3;                 // maximum displacement
constexpr int SHIFTS = (2 * D + 1) * (2 * D + 1);
constexpr int TH = 8;                // tile rows
constexpr int TW = 8;                // tile columns
constexpr int CC = 32;               // channels per stage
constexpr int CS = CC + 1;           // channel stride in shared memory
constexpr int HH = TH + 2 * D;       // halo tile rows
constexpr int HW = TW + 2 * D;       // halo tile columns
constexpr int THREADS = 256;
constexpr int NPIX = TH * TW;
constexpr int NPAIR = NPIX * SHIFTS;
constexpr int PER_THREAD = (NPAIR + THREADS - 1) / THREADS;
constexpr int MAX_GRID_Z = 65535;

__global__ void __launch_bounds__(THREADS) correlation_kernel(
    const float* __restrict__ f1, const float* __restrict__ f2,
    float* __restrict__ out, int B, int H, int W, int C) {
  __shared__ float s1[NPIX * CS];
  __shared__ float s2[HH * HW * CS];
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* f1b = f1 + int64_t(b) * H * W * C;
    const float* f2b = f2 + int64_t(b) * H * W * C;
    float acc[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) acc[k] = 0.f;

    for (int c0 = 0; c0 < C; c0 += CC) {
      for (int e = threadIdx.x; e < NPIX * CC; e += THREADS) {
        const int pix = e / CC;
        const int c = e - pix * CC;
        const int y = y0 + pix / TW;
        const int x = x0 + pix % TW;
        float val = 0.f;
        if (y < H && x < W && c0 + c < C) {
          val = f1b[(int64_t(y) * W + x) * C + c0 + c];
        }
        s1[pix * CS + c] = val;
      }
      for (int e = threadIdx.x; e < HH * HW * CC; e += THREADS) {
        const int q = e / CC;
        const int c = e - q * CC;
        const int y = y0 - D + q / HW;
        const int x = x0 - D + q % HW;
        float val = 0.f;
        if (y >= 0 && y < H && x >= 0 && x < W && c0 + c < C) {
          val = f2b[(int64_t(y) * W + x) * C + c0 + c];
        }
        s2[q * CS + c] = val;
      }
      __syncthreads();

      const int cn = C - c0 < CC ? C - c0 : CC;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int pair = threadIdx.x + k * THREADS;
        if (pair < NPAIR) {
          const int pix = pair / SHIFTS;
          const int s = pair - pix * SHIFTS;
          const int ty = pix / TW;
          const int tx = pix - ty * TW;
          // Halo origin is (y0 - D, x0 - D): shift (dy, dx) = (s/7 - D,
          // s%7 - D) lands at halo cell (ty + s/7, tx + s%7).
          const float* a = s1 + pix * CS;
          const float* bb = s2 + ((ty + s / (2 * D + 1)) * HW
                                  + tx + s % (2 * D + 1)) * CS;
          float sum = acc[k];
          for (int c = 0; c < cn; ++c) sum = fmaf(a[c], bb[c], sum);
          acc[k] = sum;
        }
      }
      __syncthreads();   // the next chunk overwrites the staged tiles
    }

    const float count = float(C);
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int pair = threadIdx.x + k * THREADS;
      if (pair < NPAIR) {
        const int pix = pair / SHIFTS;
        const int s = pair - pix * SHIFTS;
        const int y = y0 + pix / TW;
        const int x = x0 + pix % TW;
        if (y < H && x < W) {
          out[((int64_t(b) * H + y) * W + x) * SHIFTS + s] = acc[k] / count;
        }
      }
    }
  }
}

}  // namespace

// f1, f2 (B, H, W, C) float32 contiguous; out (B, H, W, 49) float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int correlation_f32(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH,
                  B < MAX_GRID_Z ? B : MAX_GRID_Z);
  correlation_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<float*>(out), B, H, W, C);
  return int(cudaGetLastError());
}
