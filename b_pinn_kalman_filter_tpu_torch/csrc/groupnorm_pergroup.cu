// act(GroupNorm(x)) over NHWC activations, with a per-channel affine: the
// first port's kernel, one block per (image, group).  The main path now runs
// csrc/groupnorm.cu; this one stays only as the yardstick that chip_smoke.py
// times beside it (ops/groupnorm.py `_groupnorm_act_pergroup`).
//
// It replaced the TPU kernel `groupnorm_act`
// (b_pinn_kalman_filter_tpu/ops/groupnorm_pallas.py:118, pallas_call in
// `_pallas_groupnorm_act` :156): statistics in f32, eps added to the
// variance, per-channel scale and bias, then SiLU, ELU or nothing, written
// in the input dtype.
//
// What bounds it on an H100: bytes.  It does about ten operations per
// element against one read and one write of the activation, far below the
// card's balance point, so the least time is 2 * B*H*W*C * itemsize bytes
// over the memory rate.
//
// Design (simple and right first): one block per (image, group).  The
// TPU kernel's lane-alignment guard (C % 128) and its VMEM budget do not
// apply here.  The block walks the group's H*W*C/G elements three times:
// the sum gives the mean, the sum of squared deviations from that mean
// gives the variance (two passes instead of the TPU kernel's
// E[x^2] - E[x]^2, which loses digits when |mean| >> std), and the third
// pass normalises, applies the affine and the activation, and stores.  A
// group is at most a few tens of KB at the U-Net's shapes, so the second
// and third reads come from L2 and device memory sees about one read and
// one write.  Neighbouring threads read neighbouring channels of a pixel,
// then the next pixel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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
  return __float2bfloat16(v);
}

// Sum of v over the block; every thread gets the result.
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) total += scratch[i];
  __syncthreads();   // scratch is reused by the next call
  return total;
}

// act: 0 = none, 1 = silu, 2 = elu.
template <typename T>
__global__ void __launch_bounds__(THREADS) groupnorm_act_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ y,
    int HW, int C, int G, int act, float eps) {
  __shared__ float scratch[THREADS / 32];
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int cg = C / G;
  const int n = HW * cg;
  const int64_t base = int64_t(b) * HW * C + int64_t(g) * cg;

  float s = 0.f;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int p = e / cg;
    s += to_float(x[base + int64_t(p) * C + (e - p * cg)]);
  }
  const float mean = block_sum(s, scratch) / float(n);

  float q = 0.f;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int p = e / cg;
    const float d = to_float(x[base + int64_t(p) * C + (e - p * cg)]) - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(block_sum(q, scratch) / float(n) + eps);

  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int p = e / cg;
    const int c = e - p * cg;
    const int64_t off = base + int64_t(p) * C + c;
    const int ch = g * cg + c;
    float v = (to_float(x[off]) - mean) * rstd * scale[ch] + bias[ch];
    if (act == 1) {
      v = v / (1.f + expf(-v));
    } else if (act == 2) {
      v = v > 0.f ? v : expm1f(v);
    }
    y[off] = from_float<T>(v);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y share it; scale and bias are
// float32).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int groupnorm_act_pergroup_nhwc(const void* x, const void* scale,
                                           const void* bias, void* y, int B,
                                           int HW, int C, int G, int act,
                                           float eps, int dtype,
                                           void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || act < 0 ||
      act > 2) {
    return int(cudaErrorInvalidValue);
  }
  const dim3 grid(unsigned(B) * unsigned(G));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    groupnorm_act_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(y),
        HW, C, G, act, eps);
  } else if (dtype == 1) {
    groupnorm_act_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(y), HW, C, G, act, eps);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
