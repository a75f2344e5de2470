// Stride-1 SAME 3x3 convolution plus bias, bf16 NHWC activations and HWIO
// weights, on Hopper's tensor cores (wgmma) fed by TMA.
//
// Replaces the TPU kernel `winograd_conv3x3_fused`
// (b_pinn_kalman_filter_tpu/ops/winograd_pallas.py:159, pallas_call :191)
// for bf16 inputs whose Cin and Cout are multiples of 8; the f32 calls and
// every other shape keep the direct kernel of csrc/conv3x3.cu.  The rule
// lives in one Python function, ops/conv3x3.py `kernel_for`.  Winograd is
// an exact rewrite of the same convolution; this kernel computes it as an
// implicit GEMM: M = B*H*W output pixels, N = Cout, K = 9*Cin, f32
// accumulation, output bf16 (round to nearest even).
//
// What bounds it on an H100: operations.  A conv does 2*9*Cin*Cout
// multiply-adds per output pixel against 2*(Cin+Cout) bytes of activations,
// far above the card's balance point, so only the tensor cores reach the
// bound.  At the U-Net's 8x8 and 4x4 levels the GEMM is too small to fill
// 132 SMs; split-K fills them.
//
// Design:
// - A block owns a 64-pixel x BN-channel output tile (BN = 64 or 128).  The
//   64 pixels are a box of whole rows of the image, (bb, hb, wb) with
//   bb*hb*wb = 64, chosen on the host (ops/conv3x3.py `wgmma_box`).
// - A K step is one tap (dy, dx) x 64 input channels.  Its A operand is one
//   4-D TMA box of the NHWC input at (c0, w0+dx-1, h0+dy-1, b0): 64 rows of
//   128 bytes, 128-byte swizzled.  TMA fills the SAME halo (and channels
//   past Cin, pixels past the image) with zeros, so no instruction masks
//   it.  Its B operand is the HWIO weights seen as (9, Cin, Cout), one box
//   of 64 input channels x 64 output channels per 64 columns of BN,
//   N-contiguous: wgmma reads it with its transpose bit, so the weights are
//   used as they lie.
// - One producer thread (warp 4) keeps a ring of 4 stages in flight; the
//   consumer warpgroup (warps 0-3) waits on each stage's mbarrier, runs 4 x
//   BN/64 `wgmma.mma_async` m64n64k16 (A and B from shared memory, the sum
//   in 32 or 64 f32 registers a thread), waits for them and frees the
//   stage.  At BN <= 128 the accumulator needs no `setmaxnreg`.
// - Split-K: a thread-block cluster of `split` blocks along grid z shares
//   one output tile, each over its own range of K steps.  Each block leaves
//   its f32 partial tile in its shared memory; after a cluster barrier,
//   block r sums rows [64r/split, 64(r+1)/split) over the cluster's blocks
//   through distributed shared memory in rank order (a fixed order: the
//   result does not change from run to run), adds the bias, rounds to bf16
//   and stores 16 bytes a thread.  Without split-K the kernel is launched
//   without a cluster (each block is then a cluster of one, and the same
//   epilogue runs).
// - Tensor maps are encoded on the host for each call
//   (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//   the library needs no -lcuda) and passed as __grid_constant__.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;            // output pixels per block (one wgmma M)
constexpr int BK = 64;            // input channels per K step (128 bytes)
constexpr int STAGES = 4;
constexpr int THREADS = 160;      // one consumer warpgroup + producer warp
constexpr int MAX_SPLIT = 8;      // portable cluster size
constexpr uint32_t A_BYTES = BM * BK * 2;
constexpr uint32_t B_BOX_BYTES = BK * 64 * 2;   // 64 input x 64 output ch

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand whose
// 8-row groups lie 1024 bytes apart.  Both A (K-major: rows are pixels) and
// B (N-major: rows are input channels) are such: 8 rows of 128 bytes.  The
// leading offset is not read for these operands (one 128-byte atom spans
// the instruction's K for A and its N = 64 for B); it is set to the same
// 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t off = 1024 >> 4;
  return uint64_t((addr & 0x3FFFF) >> 4) | (off << 16) | (off << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64, f32, the warpgroup's fragment) += A (64 x 16, K-major) *
// B (16 x 64, N-major: transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <int BN>
struct Layout {
  static constexpr uint32_t B_BYTES = (BN / 64) * B_BOX_BYTES;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr uint32_t RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int LD = BN + 4;          // f32 partial tile row, padded
  // 1024 bytes of slack to align the ring, the ring, 2 barriers a stage.
  static constexpr uint32_t SMEM_BYTES = 1024 + RING_BYTES + 16 * STAGES;
  static_assert(BM * LD * 4 <= RING_BYTES, "partial tile overlays the ring");
};

template <int BN>
__global__ void __launch_bounds__(THREADS) conv3x3_wgmma_kernel(
    __grid_constant__ const CUtensorMap xmap,
    __grid_constant__ const CUtensorMap wmap,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
    int B, int H, int W, int Cout, int bb, int hb, int wb, int tiles_h,
    int tiles_w, int cchunks, int split) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;           // 1024-aligned: swizzle atoms
  const uint32_t ring = raw + pad;
  const uint32_t a_base = ring;
  const uint32_t b_base = ring + STAGES * A_BYTES;
  const uint32_t bars = ring + L::RING_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());   // the split-K index
  const int tw = blockIdx.x % tiles_w;
  const int th = (blockIdx.x / tiles_w) % tiles_h;
  const int tb = blockIdx.x / (tiles_w * tiles_h);
  const int w0 = tw * wb, h0 = th * hb, b0 = tb * bb;
  const int n0 = blockIdx.y * BN;
  const int nk = 9 * cchunks;
  const int k_begin = rank * nk / split;
  const int k_end = (rank + 1) * nk / split;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 64][32];
#pragma unroll
  for (int h = 0; h < BN / 64; ++h)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[h][j] = 0.f;

  if (threadIdx.x == 128) {
    // Producer: one thread issues every copy.
    for (int ks = k_begin, it = 0; ks < k_end; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
      const int tap = ks / cchunks;
      const int c0 = (ks - tap * cchunks) * BK;
      mbar_expect_tx(full(s), L::STAGE_BYTES);
      tma_load_4d(a_base + s * A_BYTES, &xmap, full(s), c0,
                  w0 + tap % 3 - 1, h0 + tap / 3 - 1, b0);
#pragma unroll
      for (int h = 0; h < BN / 64; ++h) {
        tma_load_3d(b_base + s * L::B_BYTES + h * B_BOX_BYTES, &wmap, full(s),
                    n0 + 64 * h, c0, tap);
      }
    }
  } else if (threadIdx.x < 128) {
    // Consumer warpgroup.
    for (int ks = k_begin, it = 0; ks < k_end; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(full(s), (it / STAGES) & 1);
      const uint32_t a = a_base + s * A_BYTES;
      const uint32_t b = b_base + s * L::B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < BN / 64; ++h) {
          // k slice kk: 32 bytes into each A row, 16 rows (2048 bytes) of B.
          wgmma_m64n64k16(acc[h], sw128_desc(a + 32 * kk),
                          sw128_desc(b + h * B_BOX_BYTES + 2048 * kk));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(empty(s));
    }
  }
  __syncthreads();   // every stage consumed: the ring is free

  // The f32 partial tile, row-major [64][LD], over the ring.
  float* part = reinterpret_cast<float*>(smem);
  if (threadIdx.x < 128) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int h = 0; h < BN / 64; ++h)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = warp * 16 + lane / 4 + 8 * i;
          const int col = h * 64 + nb * 8 + (lane % 4) * 2;
          *reinterpret_cast<float2*>(&part[row * L::LD + col]) =
              make_float2(acc[h][nb * 4 + i * 2], acc[h][nb * 4 + i * 2 + 1]);
        }
  }
  cluster.sync();

  // Rows [r_begin, r_end) of the tile: sum the cluster's partials in rank
  // order, add the bias, round to bf16, store 8 channels (16 bytes) a item.
  constexpr int CHUNKS = BN / 8;
  const int r_begin = rank * BM / split;
  const int r_end = (rank + 1) * BM / split;
  for (int item = threadIdx.x; item < (r_end - r_begin) * CHUNKS;
       item += THREADS) {
    const int row = r_begin + item / CHUNKS;
    const int c = (item % CHUNKS) * 8;
    const int n = n0 + c;
    const int bi = row / (hb * wb);
    const int hi = (row / wb) % hb;
    const int wi = row % wb;
    const int pb = b0 + bi, ph = h0 + hi, pw = w0 + wi;
    if (n >= Cout || pb >= B || ph >= H || pw >= W) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    for (int r = 0; r < split; ++r) {
      const float4* p = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part + row * L::LD + c, r));
      const float4 lo = p[0], hi4 = p[1];
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi4.x; v[5] += hi4.y; v[6] += hi4.z; v[7] += hi4.w;
    }
    uint4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = __floats2bfloat162_rn(v[2 * j] + bias[n + 2 * j],
                                   v[2 * j + 1] + bias[n + 2 * j + 1]);
    }
    const int64_t off = ((int64_t(pb) * H + ph) * W + pw) * Cout + n;
    *reinterpret_cast<uint4*>(y + off) = out;
  }
  cluster.sync();    // no block leaves while another reads its partials
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Error codes past the CUDA runtime's: no tensor-map encoder, or a map the
// encoder refused.
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE_X = 10002;
constexpr int ERR_ENCODE_W = 10003;

template <int BN>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* bias,
           __nv_bfloat16* y, int B, int H, int W, int Cout, int bb, int hb,
           int wb, int cchunks, int split, cudaStream_t s) {
  using L = Layout<BN>;
  static bool smem_set = false;    // the attribute holds for the process
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(L::SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    smem_set = true;
  }
  const int tiles_h = (H + hb - 1) / hb;
  const int tiles_w = (W + wb - 1) / wb;
  const int tiles_b = (B + bb - 1) / bb;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(tiles_b * tiles_h * tiles_w),
                     unsigned((Cout + BN - 1) / BN), unsigned(split));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = unsigned(split);
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;   // no split: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, conv3x3_wgmma_kernel<BN>, xmap, wmap, bias, y, B, H, W, Cout, bb,
      hb, wb, tiles_h, tiles_w, cchunks, split);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// x (B,H,W,Cin) bf16, w (3,3,Cin,Cout) bf16, bias (Cout,) f32, y
// (B,H,W,Cout) bf16, all contiguous and 16-byte aligned; Cin and Cout
// multiples of 8.  The tile plan (bn, the box bb x hb x wb = 64 pixels, and
// split) comes from ops/conv3x3.py `wgmma_plan`.  Returns 0 on success, a
// CUDA error code, or one of the ERR_* codes above.
extern "C" int conv3x3_wgmma_nhwc(const void* x, const void* w,
                                  const void* bias, void* y, int B, int H,
                                  int W, int Cin, int Cout, int bn, int bb,
                                  int hb, int wb, int split, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 ||
      Cout % 8 || (bn != 64 && bn != 128) || bb <= 0 || hb <= 0 || wb <= 0 ||
      bb * hb * wb != BM || bb > 256 || hb > 256 || wb > 256 || split < 1 ||
      split > MAX_SPLIT || (reinterpret_cast<uintptr_t>(x) |
                            reinterpret_cast<uintptr_t>(w) |
                            reinterpret_cast<uintptr_t>(y)) % 16) {
    return int(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint32_t ones[4] = {1, 1, 1, 1};

  // NHWC input as (Cin, W, H, B), innermost first; box (64, wb, hb, bb).
  CUtensorMap xmap;
  const cuuint64_t xdim[4] = {cuuint64_t(Cin), cuuint64_t(W), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t xstride[3] = {cuuint64_t(Cin) * 2,
                                 cuuint64_t(W) * Cin * 2,
                                 cuuint64_t(H) * W * Cin * 2};
  const cuuint32_t xbox[4] = {cuuint32_t(BK), cuuint32_t(wb), cuuint32_t(hb),
                              cuuint32_t(bb)};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             xdim, xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return ERR_ENCODE_X;
  }
  // HWIO weights as (Cout, Cin, 9), innermost first; box (64, 64, 1).
  CUtensorMap wmap;
  const cuuint64_t wdim[3] = {cuuint64_t(Cout), cuuint64_t(Cin), 9};
  const cuuint64_t wstride[2] = {cuuint64_t(Cout) * 2,
                                 cuuint64_t(Cin) * Cout * 2};
  const cuuint32_t wbox[3] = {64, cuuint32_t(BK), 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
             wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return ERR_ENCODE_W;
  }

  const int cchunks = (Cin + BK - 1) / BK;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y);
  if (bn == 64) {
    return launch<64>(xmap, wmap, b, out, B, H, W, Cout, bb, hb, wb, cchunks,
                      split, s);
  }
  return launch<128>(xmap, wmap, b, out, B, H, W, Cout, bb, hb, wb, cchunks,
                     split, s);
}
