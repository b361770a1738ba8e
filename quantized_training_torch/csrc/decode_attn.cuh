// Pieces of a decode-step attention kernel on mma.sync (one query token per
// head; the G <= 8 query heads of one kv head as the rows of S = Q K^T), for
// the kernels whose tokens are split over the blocks of a cluster:
//   * The split: the blocks of one (batch, kv head) pair form one thread
//     block cluster (at most 8), and the 4 * splits warps of the cluster
//     share each tier's steps evenly (`warp_steps`).  The rule that picks
//     the cluster size is plain Python beside each wrapper
//     (ops/kivi_attention.py:kivi_decode_plan,
//     ops/int_kv_attention.py:int_kv_decode_plan, both on
//     ops/_decode_attn.py:cluster_splits), so that the CPU tests hold it to
//     its contract; the kernel takes it as a launch argument.
//   * Two phases, so that p is rounded against the pair's global max, as
//     the TPU kernel rounds it: each warp computes its scores (phase 1) into
//     shared memory and its running max; `cluster_max` meets the blocks'
//     maxima over distributed shared memory; then (phase 2) `p_frags` turns
//     the scores into p = exp(s - m), times a per-token weight where the
//     kernel has one, rounded to bf16 and packed straight into the B
//     fragment of P^T for O^T = V^T P^T, the sums unrounded.
//   * `cluster_finish`: the warps' partials (sum of p, accumulator, and an
//     extra per-head term: f32 summed before it is rounded, or int32 sums
//     added as integers and converted once) are added in warp order, then
//     each block of the cluster adds the blocks' partials of its share of
//     the outputs in rank order over distributed shared memory and writes
//     them: the same bits from every call, no atomics and no workspace.
// Used by kivi_decode.cu (kernel 8) and int_kv_decode.cu (kernel 7).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_tile.cuh"  // round_bf16, pack_bf16, quad sums, cp.async, mma

namespace dattn {

constexpr int WARPS = 4;                 // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int STEP = 16;                 // tokens a warp step (k of P V)

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}

// ---- clusters ------------------------------------------------------------
constexpr int MAX_SPLITS = 8;            // blocks a cluster (portable size)

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// *p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote)
               : "memory");
  return v;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Warp `w` of the W = 4 * splits warps of a cluster takes steps [s0, s1) of
// a tier of n steps: an even share, in order.
__host__ __device__ inline void warp_steps(int w, int W, int n, int& s0,
                                           int& s1) {
  s0 = static_cast<int>(static_cast<long long>(w) * n / W);
  s1 = static_cast<int>(static_cast<long long>(w + 1) * n / W);
}

// The pair's max of each head: `wmax` [WARPS][G] holds the warps' maxima,
// `bmax` [G] receives the block's, which the cluster's blocks read from each
// other.  Returns head g's max for lane group g (g < G); -inf where no token
// of the pair is visible.
template <int G>
__device__ __forceinline__ float cluster_max(const float* wmax, float* bmax,
                                             int splits) {
  __syncthreads();
  if (threadIdx.x < G) {
    float m = wmax[threadIdx.x];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, wmax[w * G + threadIdx.x]);
    bmax[threadIdx.x] = m;
  }
  cluster_sync();
  const int g = min((threadIdx.x & 31) >> 2, G - 1);
  float m = -INFINITY;
  for (int r = 0; r < splits; ++r) m = fmaxf(m, ld_cluster(bmax + g, r));
  return m;
}

// p of one step from its scores s[x][e] (head g, column 2t + e of n8 tile
// x; -inf where not visible) against the pair's max m: adds exp(s - m) to
// l and packs p * w[x][e], rounded to bf16, into pb, the B fragment of P^T
// (k = the 16 tokens, n = the heads).  EXACT takes expf (the plain
// versions' exp), else the faster __expf.
template <bool EXACT = false>
__device__ __forceinline__ void p_frags(const float (&s)[2][2], float m,
                                        float& l, uint32_t (&pb)[2],
                                        const float (&w)[2][2]) {
  float p[2][2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = s[x][e] == -INFINITY
                          ? 0.f
                          : (EXACT ? expf(s[x][e] - m) : __expf(s[x][e] - m));
      l += v;
      p[x][e] = __fmul_rn(v, w[x][e]);
    }
  pb[0] = pack_bf16(p[0][0], p[0][1]);
  pb[1] = pack_bf16(p[1][0], p[1][1]);
}

__device__ __forceinline__ void p_frags(const float (&s)[2][2], float m,
                                        float& l, uint32_t (&pb)[2]) {
  const float one[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
  p_frags<false>(s, m, l, pb, one);
}

// ---- partials and the merge ------------------------------------------------
// A partial of one (batch, kv head) pair: per query head h < G a record of
// `rec` floats, [l, acc[0 .. D), extra[0 .. rec - 1 - D)].  The extra term:
enum Extra {
  EXTRA_NONE = 0,  // none: out = acc / l
  EXTRA_BF16 = 1,  // f32, one per ext_div features, rounded to bf16 once
                   // summed: out = (acc + bf16(extra[d / ext_div])) / l
  EXTRA_INT = 2,   // int32 sums (as their bits), one per feature, added as
                   // integers and converted once: out = (float(extra[d]) *
                   // ext_scale + acc) / l
};

// The end of a block: `warps` holds the WARPS warps' partials (stride
// G * rec floats), `blk` room for one more, which the cluster's blocks read.
// Together they write out[h][d] = bf16(the Extra form's output) for the G
// heads at `out`.
template <int G, int D, int EXTRA>
__device__ __forceinline__ void cluster_finish(const float* warps, float* blk,
                                               int rec, int ext_div,
                                               float ext_scale, int splits,
                                               uint16_t* out) {
  __syncthreads();
  for (int i = threadIdx.x; i < G * rec; i += blockDim.x) {
    if (EXTRA == EXTRA_INT && i % rec > D) {
      int v = __float_as_int(warps[i]);
      for (int w = 1; w < WARPS; ++w) v += __float_as_int(warps[w * G * rec + i]);
      blk[i] = __int_as_float(v);
    } else {
      float v = warps[i];
      for (int w = 1; w < WARPS; ++w) v += warps[w * G * rec + i];
      blk[i] = v;
    }
  }
  cluster_sync();
  // block r of the cluster writes its share of the outputs, each the sum of
  // the blocks' partials in rank order
  const int n = G * D, r = blockIdx.x;
  for (int idx = r * n / splits + threadIdx.x; idx < (r + 1) * n / splits;
       idx += blockDim.x) {
    const int h = idx / D, d = idx % D;
    float l = 0.f, acc = 0.f, ext = 0.f;
    int iext = 0;
    for (int k = 0; k < splits; ++k) {
      l += ld_cluster(blk + h * rec, k);
      acc += ld_cluster(blk + h * rec + 1 + d, k);
      if (EXTRA == EXTRA_BF16)
        ext += ld_cluster(blk + h * rec + 1 + D + d / ext_div, k);
      if (EXTRA == EXTRA_INT)
        iext += __float_as_int(ld_cluster(blk + h * rec + 1 + D + d, k));
    }
    const float num =
        EXTRA == EXTRA_BF16 ? acc + round_bf16(ext)
        : EXTRA == EXTRA_INT
            ? __fadd_rn(__fmul_rn(__int2float_rn(iext), ext_scale), acc)
            : acc;
    const float v = round_bf16(__fdiv_rn(num, l == 0.f ? 1.f : l));
    out[static_cast<size_t>(h) * D + d] =
        static_cast<uint16_t>(__float_as_uint(v) >> 16);
  }
  cluster_sync();  // every block's partial has been read
}

// ---- the host side -----------------------------------------------------------
constexpr int MAX_SMEM = 227 * 1024;  // shared memory a block on an H100

// Calls f(D, G) as std::integral_constants for an instantiated head dim D
// in {64, 128} and group G in {1, 2, 4, 8}; false for any other pair.
template <typename Fn>
bool with_dg(int D, int G, Fn&& f) {
  auto at = [&](auto d) {
    switch (G) {
      case 1: f(d, std::integral_constant<int, 1>{}); return true;
      case 2: f(d, std::integral_constant<int, 2>{}); return true;
      case 4: f(d, std::integral_constant<int, 4>{}); return true;
      case 8: f(d, std::integral_constant<int, 8>{}); return true;
      default: return false;
    }
  };
  if (D == 64) return at(std::integral_constant<int, 64>{});
  if (D == 128) return at(std::integral_constant<int, 128>{});
  return false;
}

// Lets KERNEL take up to MAX_SMEM of dynamic shared memory, once: a cap set
// to one launch's need would refuse a later, larger launch.
template <auto KERNEL>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  return err;
}

}  // namespace dattn
