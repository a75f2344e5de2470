// Stride-1 SAME 3x3 convolution plus bias, NHWC activations, HWIO weights.
//
// Replaces the TPU kernel `winograd_conv3x3_fused`
// (b_pinn_kalman_filter_tpu/ops/winograd_pallas.py:159, reached through
// ops/winograd.py `conv3x3_fast`).  That kernel computes the convolution
// as Winograd F(2x2,3x3); Winograd is an exact rewrite of the same
// convolution, so this kernel computes the same function directly.
//
// What bounds it on an H100: operations.  At the U-Net's shapes a conv does
// 2*9*Cin*Cout multiply-adds per output pixel against 2*(Cin+Cout) bytes of
// activations (bf16), i.e. hundreds of operations per byte, far above the
// card's balance point, so the bound is the arithmetic rate.
//
// Design (simple and right first): a direct implicit GEMM.  The GEMM is
// M = B*H*W output pixels by N = Cout, over K = 9*Cin; its A operand is the
// input gathered per tap with the SAME-padding halo masked to zero, its B
// operand the HWIO weights read as a (9*Cin, Cout) row-major matrix.  Each
// block owns a 64-pixel x 64-channel output tile and loops over the 9 taps
// and over Cin in chunks of 32, staging both operands through shared memory
// as f32 with loads where neighbouring threads read neighbouring channels.
// Each thread accumulates a 4x4 sub-tile in f32 registers on the CUDA cores
// (plain FMA), adds the bias and writes in the input dtype (f32 or bf16).
// Tensor cores (mma/wgmma), TMA and Winograd are left to later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // input channels per shared-memory stage
constexpr int THREADS = 256;
constexpr int A_ROWS = THREADS / BK;   // pixel rows one pass of loads covers
constexpr int B_ROWS = THREADS / BN;   // weight rows one pass of loads covers

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

template <typename T>
__global__ void __launch_bounds__(THREADS) conv3x3_nhwc_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ y,
    int B, int H, int W, int Cin, int Cout) {
  // As is stored k-major with one float of padding so that the stores,
  // where a warp spans 32 channels of one pixel, hit 32 different banks.
  __shared__ float As[BK][BM + 1];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int M = B * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Loader roles.  A: channel a_k of pixel rows a_row + A_ROWS*r.
  const int a_k = tid % BK;
  const int a_row = tid / BK;
  int pix_b[BM / A_ROWS], pix_h[BM / A_ROWS], pix_w[BM / A_ROWS];
#pragma unroll
  for (int r = 0; r < BM / A_ROWS; ++r) {
    const int m = m0 + a_row + A_ROWS * r;
    if (m < M) {
      pix_b[r] = m / (H * W);
      const int hw = m - pix_b[r] * H * W;
      pix_h[r] = hw / W;
      pix_w[r] = hw - pix_h[r] * W;
    } else {
      pix_b[r] = -1;            // past the last pixel: loads zero
      pix_h[r] = 0;
      pix_w[r] = 0;
    }
  }
  // B: output channel b_n of weight rows b_row + B_ROWS*r.
  const int b_n = tid % BN;
  const int b_row = tid / BN;

  // Compute role: a 4x4 sub-tile at rows ty*4.., columns tx*4..
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int ci = c0 + a_k;
#pragma unroll
      for (int r = 0; r < BM / A_ROWS; ++r) {
        const int ih = pix_h[r] + dy;
        const int iw = pix_w[r] + dx;
        float v = 0.f;
        if (pix_b[r] >= 0 && ci < Cin && ih >= 0 && ih < H && iw >= 0 &&
            iw < W) {
          const int64_t off =
              ((int64_t(pix_b[r]) * H + ih) * W + iw) * Cin + ci;
          v = to_float(x[off]);
        }
        As[a_k][a_row + A_ROWS * r] = v;
      }
      const int n = n0 + b_n;
#pragma unroll
      for (int r = 0; r < BK / B_ROWS; ++r) {
        const int k = b_row + B_ROWS * r;
        float v = 0.f;
        if (c0 + k < Cin && n < Cout) {
          const int64_t off = (int64_t(tap) * Cin + c0 + k) * Cout + n;
          v = to_float(w[off]);
        }
        Bs[k][b_n] = v;
      }
      __syncthreads();

#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cout) {
        y[int64_t(m) * Cout + n] = from_float<T>(acc[i][j] + bias[n]);
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it; bias is float32).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int conv3x3_nhwc(const void* x, const void* w, const void* bias,
                            void* y, int B, int H, int W, int Cin, int Cout,
                            int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0) {
    return int(cudaErrorInvalidValue);
  }
  const int64_t M = int64_t(B) * H * W;
  const dim3 grid(unsigned((M + BM - 1) / BM), unsigned((Cout + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv3x3_nhwc_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y),
        B, H, W, Cin, Cout);
  } else if (dtype == 1) {
    conv3x3_nhwc_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y),
        B, H, W, Cin, Cout);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
