// The pipeline of the tensor-core GEMMs that dequantize their weight in
// registers (affine_w4_matmul.cu:w4_gemm_tc, byte_storage_gemm.cuh:gemm_tc),
// whose mbarrier and TMA helpers the int-sym decode (int_kv_decode.cu) also
// feeds its rings with:
// the mbarriers that pass ring stages between a producer warp and the
// consumer warpgroups, the TMA loads and the tensor maps they read, the
// consumers' k loop over the ring and their output staging, and the token
// tile of a launch.  The kernels differ in their producers and in how a
// thread builds its A fragment from a stage.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

constexpr int TC_CONSUMERS = 256;              // two consumer warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // and the producer warp
constexpr int TC_BN = 128;                     // output columns per block
constexpr int TC_BK = 64;                      // k per ring stage
constexpr int TC_OUT_STRIDE = TC_BN + 8;       // bf16 a staged output row

// ---- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// waits until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one arrival, which releases this thread's earlier writes to shared memory
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// an arrival where pred holds, as a predicated instruction: a branch
// between a wgmma and its wait makes ptxas serialize the products
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 st;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}

// one arrival on bar once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// one more arrival on bar, which also awaits bytes of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// TMA: the 2-D box of map at (c0, c1), innermost first, into shared memory
// at dst, its bytes counted on bar; the box's part outside the tensor reads
// as zero
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// TMA: a 1-D bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global memory into shared memory at dst, its bytes
// counted on bar
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const void* src,
                                            uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// makes barriers just initialized visible to the asynchronous copies
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders this thread's earlier accesses of shared memory before later
// asynchronous copies into it (a ring slot read, then refilled by TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumers' own barrier (named barrier 1), without the producer warp
template <int THREADS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// the ring's barriers: full (one a stage: the producer's arrivals) at
// full.., empty (one arrival a consumer warp) at empty..
__device__ __forceinline__ void tc_init_barriers(uint32_t full, uint32_t empty,
                                                 int stages, int arrivals) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(full + 8 * s, arrivals);
    mbar_init(empty + 8 * s, TC_CONSUMERS / 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---- the consumers ------------------------------------------------------------
// y^T += W^T x^T over nsteps ring stages: stage st's x tile (BM tokens x 64
// k, K-major, 128-byte swizzle) at x0 + st * x_stride is wgmma's B operand,
// and the A registers of its k step kk (64 output columns x 16 k of this
// thread's warpgroup) are built by frag(kk, a) after load(st) has read what
// the stage's four k steps share.  The A registers are double-buffered and
// one product stays in flight, so one k step's dequant overlaps the product
// before it.  Once a stage's products are done its slot goes back, one
// predicated arrival a consumer warp: a branch between a wgmma and its wait
// makes ptxas serialize the products (C7513), and 256 arrivals a stage
// slowed them.
template <int BM, int STAGES, class Load, class Frag>
__device__ __forceinline__ void tc_consume(float (&acc)[BM / 2], uint32_t full,
                                           uint32_t empty, uint32_t x0,
                                           uint32_t x_stride, int nsteps,
                                           int lane, Load load, Frag frag) {
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t regs[2][4];  // the A registers of two k steps
  for (int t = 0; t < nsteps; ++t) {
    const int st = t % STAGES;
    mbar_wait(full + 8 * st, (t / STAGES) & 1);
    const uint32_t xs = x0 + st * x_stride;
    load(st);
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t(&a)[4] = regs[kk & 1];
      frag(kk, a);
      fence_regs(acc);
      wg_fence();
      wgmma_rs_kmajor(acc, a, kmajor_desc<BM>(xs, kk));
      wg_commit();
      fence_regs(acc);
      // the previous k step's product is done: its A registers may be
      // written again
      wg_wait<1>();
      fence_regs(regs);
      // and so is every product of stage t - 1: its slot goes back
      if (kk == 0)
        mbar_arrive_if(empty + 8 * ((t + STAGES - 1) % STAGES),
                       lane == 0 && t > 0);
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(regs);
}

// The sums -> a staged [token][column] bf16 tile at out (BM rows of
// TC_OUT_STRIDE, over the ring once both warpgroups are done with it) ->
// coalesced rows of y (M, N) at tokens m0.., columns n0...  Elements i and
// i + 1 of a group of four are this thread's A row a, output column col of
// the block, at tokens 8 (i / 4) + 2q and + 1; elements i + 2 and i + 3
// its row a + 8, column col + COL_STEP.
template <int BM, int COL_STEP>
__device__ __forceinline__ void tc_store(const float (&acc)[BM / 2],
                                         uint16_t* out,
                                         uint16_t* __restrict__ y, int col,
                                         int q, int tid, int m0, int n0, int M,
                                         int N) {
  consumers_sync<TC_CONSUMERS>();  // both warpgroups are done with the ring
#pragma unroll
  for (int i = 0; i < BM / 2; i += 4) {
    uint16_t* o = out + (8 * (i >> 2) + 2 * q) * TC_OUT_STRIDE + col;
    if constexpr (COL_STEP == 1) {
      // the two columns adjacent: one 32-bit store a token
      *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[i], acc[i + 2]);
      *reinterpret_cast<uint32_t*>(o + TC_OUT_STRIDE) =
          pack_bf16(acc[i + 1], acc[i + 3]);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v = pack_bf16(acc[i + 2 * h], acc[i + 2 * h + 1]);
        o[COL_STEP * h] = static_cast<uint16_t>(v & 0xffffu);
        o[TC_OUT_STRIDE + COL_STEP * h] = static_cast<uint16_t>(v >> 16);
      }
    }
  }
  consumers_sync<TC_CONSUMERS>();
  for (int c = tid; c < BM * (TC_BN / 8); c += TC_CONSUMERS) {
    const int r = c / (TC_BN / 8), cc = c % (TC_BN / 8);
    const int m = m0 + r, n = n0 + 8 * cc;
    if (m >= M || n >= N) continue;
    const uint16_t* src = out + r * TC_OUT_STRIDE + 8 * cc;
    uint16_t* dst = y + static_cast<size_t>(m) * N + n;
    if ((N & 7) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && n + j < N; ++j) dst[j] = src[j];
    }
  }
}

// ---- tensor maps --------------------------------------------------------------
// cuTensorMapEncodeTiled, looked up in the libcuda the process has
// loaded (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a row-major (rows, cols) tensor of elem-byte values as box_cols x
// box_rows boxes
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, int cols, int rows, int elem,
                       int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// ---- the token tile ---------------------------------------------------------
// As narrow as M allows, and 256 (half the dequant a product) where its
// blocks of bn output columns still cover half of the card's sms SMs
int pick_tile_m(int M, int N, int bn, int sms) {
  if (M <= 64) return 64;
  if (M <= 128) return 128;
  const long blocks = static_cast<long>((N + bn - 1) / bn) * ((M + 255) / 256);
  return 2 * blocks >= sms ? 256 : 128;
}

}  // namespace
