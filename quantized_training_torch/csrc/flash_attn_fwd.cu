// Causal GQA flash attention forward on Hopper's tensor cores, in four forms:
//   flash_attn_fwd: single pass, online softmax (form 1), optionally with
//     the row logsumexp for training (form 2);
//   flash_attn_fwd_two_pass: the probabilities rounded to a format (p_fmt)
//     and, optionally, the output rounded in the epilogue (out_fmt) (form
//     3); with an lse, also o_unq, the output with p unrounded (form 4).
//   q (B, H, S, D), k/v (B, KV, T, D) bf16, out (B, H, S, D) bf16; query row
//   i sits at absolute position q_offset + i; head h reads kv head
//   h / (H / KV); f32 softmax statistics; masked scores are NEG_INF = -2^30.
//
// Replaces quantized_training_tpu/ops/pallas/flash_attention.py:66
// (_attn_kernel, reached through flash_attention), and rounds where it
// rounds.  Single pass: p = exp(s - m_new) feeds l in f32 and is rounded to
// bf16 only as the A operand of p @ v; alpha = exp(m - m_new) rescales the
// running sums, and a row whose l is 0 divides by 1.  Two pass (the TPU
// kernel's p_qfn form, :160-216): pass 1 computes scores only (no V is
// loaded) and turns the running max and sum of each row, updated once per
// 128 keys as the TPU kernel's block_k, into its logsumexp; pass 2
// recomputes each score tile, rounds p = exp(s * scale - lse) (the product
// rounded first, as the TPU kernel scales s) to bf16 and then through the p
// format (qt_round.cuh) in registers, and accumulates round(p) @ v with no
// final division; the out format, if any, rounds the bf16 output before
// the store.  Training forms (the TPU kernel's save_lse, :214-226): an f32
// lse (B, H, S) receives each row's logsumexp m + log(l) (l == 0 taken as
// 1), one value per row; the two-pass kernel with an lse also accumulates
// bf16(p) @ v beside round(p) @ v (:183-187), in a second accumulator, and
// writes it as o_unq.
//
// What bounds it on an H100: the causal operations, 4*S^2*D*H/2 per batch
// row for one pass and 6*S^2*D*H/2 for two (pass 1 computes scores only),
// over the 989 TFLOP/s bf16 tensor-core rate; the score tensor never leaves
// the registers.  Design:
//   * one block of two warpgroups per (128-row q tile, head, batch); each
//     warpgroup owns 64 query rows and computes S = Q K^T with
//     wgmma.mma_async (m64n64k16, Q and K from shared memory) and
//     O += P V (m64nDk16) with P from registers and V from shared memory,
//     bf16 operands and f32 sums, as the TPU kernel's bf16 dots.  In the
//     two-pass forms S is summed 16 dims at a time and the chunks added in
//     f32 (see scores()): the probabilities' posit roundings turn a score's
//     last bit into a rounding step, so those scores stay within about an
//     ulp of the exact dot;
//   * P is the S accumulator fragment itself: exp, the bf16 and format
//     roundings and the masks are applied to it in registers, then it is
//     packed into the A operand (the accumulator and A fragment layouts
//     agree element for element), so no score or probability touches
//     shared memory;
//   * Q (128 x D) and a ring of three K/V stages of 64 keys are filled with
//     16-byte cp.async.cg copies (zero-filled past S and T) in the 128-byte
//     swizzled layout wgmma reads: D/64 blocks of rows of 128 bytes, the
//     16-byte chunk index XOR the row index mod 8.  K is K-major for Q K^T;
//     V, stored the same way, is the MN-major B operand of P V;
//   * key tiles above the diagonal are never loaded, and a warpgroup skips
//     the tiles wholly above its own rows; q tiles are launched longest
//     first (blockIdx.y counts down the diagonal), so the causal tail
//     starts early on the 132 SMs.  GQA heads are not stacked: each block
//     reads its kv head's tiles through L2.
// D is 64 or 128; any S and T are taken (ragged tiles are masked).

#include <cuda_runtime.h>
#include <stdint.h>

#include "qt_round.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int BQ = 128;             // query rows per block (two warpgroups)
constexpr int BK = 64;              // keys per tile
constexpr int NSTAGE = 3;           // K/V ring depth
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1073741824.0f;  // -2^30

template <int D>
struct Layout {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // + 1024: the swizzle atoms need 1024-byte alignment
  static constexpr int SMEM_BYTES = Q_BYTES + NSTAGE * STAGE_BYTES + 1024;
  static_assert(SMEM_BYTES <= 232448, "over the H100's shared memory");
};

// Fragments: wgmma_tile.cuh's accumulator layout.
constexpr int NS = BK / 8 * 4;      // score elements per thread

// s = Q K^T for the warpgroup's rows over the key tile at k_st (unscaled).
// The tensor cores' f32 sums truncate as they accumulate, so a chain of
// D/16 steps drifts from the exact dot by a few ulps, biased toward 0.  The
// single pass takes the chain: its p is rounded only to bf16, a step far
// above those ulps.  The two-pass forms (CHUNKED) round p through formats
// as coarse as posit8, where a score's last bit decides a rounding step
// (PERF.md): each 16-deep chunk is summed alone and the chunks are
// added in f32 with round-to-nearest, which keeps s within about an ulp of
// the exact dot rounded once.  One accumulator array serves every chunk, one
// chunk at a time: ptxas takes minutes over two in flight at once.
template <int D, bool CHUNKED>
__device__ __forceinline__ void scores(float (&s)[NS], uint32_t q_s,
                                       uint32_t k_st, int wg) {
  auto desc_q = [&](int kk) {
    return kmajor_desc<BQ>(q_s + wg * (64 * ROW_BYTES), kk);
  };
  auto desc_k = [&](int kk) { return kmajor_desc<BK>(k_st, kk); };
  if constexpr (!CHUNKED) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_q(kk), desc_k(kk), kk > 0);
    wg_commit_wait();
    fence_regs(s);
  } else {
    float t[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) t[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      fence_regs(t);
      wg_fence();
      wgmma_ss(t, desc_q(kk), desc_k(kk), 0);
      wg_commit_wait();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = kk == 0 ? t[i] : __fadd_rn(s[i], t[i]);
    }
  }
}

// The A operand of P @ V: p (exact bf16 values) packed in pairs
using PFrag = uint32_t[BK / 16][4];

// Where a thread's fragment elements sit: column col0 + ... of a tile,
// rows at absolute positions qpos_a and qpos_a + 8
struct Pos {
  int col0, qpos_a, T, causal;
  // key k0 + the column of element i is visible from the element's row
  __device__ __forceinline__ bool visible(int i, int k0) const {
    const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
    return kpos < T && (!causal || kpos <= qpos_a + 8 * row_b(i));
  }
};

// The scaled scores (the product rounded, never fused into what follows)
// with masked ones at NEG_INF, and each row's max over the tile (across the
// quad of threads that hold the row).  MASK: the tile reaches past T or
// above a row's diagonal.
template <bool MASK>
__device__ __forceinline__ void scale_max(float (&s)[NS], float scale,
                                          const Pos& pos, int k0, float& mx_a,
                                          float& mx_b) {
  mx_a = mx_b = NEG_INF;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = (MASK && !pos.visible(i, k0)) ? NEG_INF : __fmul_rn(s[i], scale);
    if (row_b(i)) mx_b = fmaxf(mx_b, s[i]);
    else mx_a = fmaxf(mx_a, s[i]);
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
}

// p = exp(s - m) in place (0 where masked) and each row's sum of p
template <bool MASK>
__device__ __forceinline__ void exp_sum(float (&s)[NS], float m_a, float m_b,
                                        const Pos& pos, int k0, float& sum_a,
                                        float& sum_b) {
  sum_a = sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = (MASK && !pos.visible(i, k0)) ? 0.f
                                          : expf(s[i] - (row_b(i) ? m_b : m_a));
    if (row_b(i)) sum_b += s[i];
    else sum_a += s[i];
  }
  sum_a = quad_sum(sum_a);
  sum_b = quad_sum(sum_b);
}

// pass 2's p = exp(s * scale - lse) rounded to bf16, in place (0 where
// masked); the product is rounded before the difference, as the TPU
// kernel scales s first
template <bool MASK>
__device__ __forceinline__ void exp_lse(float (&s)[NS], float scale,
                                        float lse_a, float lse_b,
                                        const Pos& pos, int k0) {
#pragma unroll
  for (int i = 0; i < NS; ++i)
    s[i] = (MASK && !pos.visible(i, k0))
               ? 0.f
               : round_bf16(expf(__fsub_rn(__fmul_rn(s[i], scale),
                                           row_b(i) ? lse_b : lse_a)));
}

template <int D, bool TWO_PASS, bool SAVE>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
          const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
          float* __restrict__ lse_out, uint16_t* __restrict__ o_unq, int H,
          int KV, int S, int T, float scale, int causal, int q_offset,
          QtFormat p_fmt, QtFormat out_fmt) {
  using L = Layout<D>;
  constexpr int NO = D / 8 * 4;  // output elements per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::Q_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int kvh = h / (H / KV);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const uint16_t* qp = q + bh * S * D;
  const uint16_t* kp = k + (static_cast<size_t>(b) * KV + kvh) * T * D;
  const uint16_t* vp = v + (static_cast<size_t>(b) * KV + kvh) * T * D;

  // this thread's rows (a, and b = a + 8) in the block
  const int row_a = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const Pos pos{2 * (lane & 3), q_offset + q0 + row_a, T, causal};

  // keys the block can see, and those its warpgroup's rows can see
  const int q_last = min(q0 + BQ, S) - 1;
  const int kend = causal ? max(0, min(T, q_offset + q_last + 1)) : T;
  const int n_tiles = (kend + BK - 1) / BK;
  const int wg_first = q0 + wg * 64;
  const int wg_kend =
      wg_first >= S ? 0
      : causal ? max(0, min(T, q_offset + min(wg_first + 63, S - 1) + 1))
               : T;

  auto stage = [&](int j) { return kv_s + (j % NSTAGE) * L::STAGE_BYTES; };
  auto issue = [&](int j, bool with_v) {
    if (j < n_tiles) {
      load_tile<D, BK, NTHREADS>(stage(j), kp, j * BK, T, tid);
      if (with_v)
        load_tile<D, BK, NTHREADS>(stage(j) + L::KV_BYTES, vp, j * BK, T, tid);
    }
    cp_async_commit();
  };
  // the oldest tile in flight is in shared memory and visible to wgmma, and
  // every warpgroup is done with the stage the next issue overwrites
  auto arrive = [&]() {
    cp_async_wait<NSTAGE - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  // a tile that reaches past T or above the warpgroup's first row's diagonal
  auto edge = [&](int k0) {
    return k0 + BK > T || (causal && k0 + BK - 1 > q_offset + wg_first);
  };

  float o_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;
  float s[NS];

  load_tile<D, BQ, NTHREADS>(q_s, qp, q0, S, tid);  // in the first copy group
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  if constexpr (!TWO_PASS) {
    for (int j = 0; j < NSTAGE - 1; ++j) issue(j, true);
    for (int j = 0; j < n_tiles; ++j) {
      arrive();
      issue(j + NSTAGE - 1, true);
      const int k0 = j * BK;
      if (k0 >= wg_kend) continue;
      scores<D, false>(s, q_s, stage(j), wg);
      const bool e = edge(k0);
      float mx_a, mx_b, sum_a, sum_b;
      if (e) scale_max<true>(s, scale, pos, k0, mx_a, mx_b);
      else scale_max<false>(s, scale, pos, k0, mx_a, mx_b);
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      if (e) exp_sum<true>(s, mn_a, mn_b, pos, k0, sum_a, sum_b);
      else exp_sum<false>(s, mn_a, mn_b, pos, k0, sum_a, sum_b);
      const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int i = 0; i < NO; ++i) o_acc[i] *= row_b(i) ? alpha_b : alpha_a;
      PFrag a;
      pack_frag(a, s);  // p rounded to bf16 as the P @ V operand
      fence_regs(a);
      fence_regs(o_acc);
      wg_fence();
      wgmma_rs_tile<BK>(o_acc, a, stage(j) + L::KV_BYTES);
      wg_commit_wait();
      fence_regs(a);
      fence_regs(o_acc);
    }
    const float den_a = l_a == 0.f ? 1.f : l_a, den_b = l_b == 0.f ? 1.f : l_b;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      o_acc[i] = o_acc[i] / (row_b(i) ? den_b : den_a);
    m_a += logf(den_a);  // the row logsumexp
    m_b += logf(den_b);
  } else {
    // pass 1: running max and sum (no V), updated once per window of two
    // tiles, the TPU kernel's 128-key block, then the lse
    float s0[NS], mx0_a = NEG_INF, mx0_b = NEG_INF;  // the window's first tile
    bool e0 = false;
    for (int j = 0; j < NSTAGE - 1; ++j) issue(j, false);
    for (int j = 0; j < n_tiles; ++j) {
      arrive();
      issue(j + NSTAGE - 1, false);
      const int k0 = j * BK;
      if (k0 >= wg_kend) continue;
      scores<D, true>(s, q_s, stage(j), wg);
      const bool e = edge(k0);
      float mx_a, mx_b, sum_a, sum_b, sum0_a = 0.f, sum0_b = 0.f;
      if (e) scale_max<true>(s, scale, pos, k0, mx_a, mx_b);
      else scale_max<false>(s, scale, pos, k0, mx_a, mx_b);
      const bool first = (j & 1) == 0;
      if (first && k0 + BK < wg_kend) {  // the window's second tile follows
#pragma unroll
        for (int i = 0; i < NS; ++i) s0[i] = s[i];
        mx0_a = mx_a;
        mx0_b = mx_b;
        e0 = e;
        continue;
      }
      const float mn_a = fmaxf(m_a, first ? mx_a : fmaxf(mx0_a, mx_a));
      const float mn_b = fmaxf(m_b, first ? mx_b : fmaxf(mx0_b, mx_b));
      if (!first && e0) exp_sum<true>(s0, mn_a, mn_b, pos, k0 - BK, sum0_a, sum0_b);
      else if (!first) exp_sum<false>(s0, mn_a, mn_b, pos, k0 - BK, sum0_a, sum0_b);
      if (e) exp_sum<true>(s, mn_a, mn_b, pos, k0, sum_a, sum_b);
      else exp_sum<false>(s, mn_a, mn_b, pos, k0, sum_a, sum_b);
      l_a = l_a * expf(m_a - mn_a) + (sum0_a + sum_a);
      l_b = l_b * expf(m_b - mn_b) + (sum0_b + sum_b);
      m_a = mn_a;
      m_b = mn_b;
    }
    m_a += logf(l_a == 0.f ? 1.f : l_a);  // m_a, m_b: the rows' lse
    m_b += logf(l_b == 0.f ? 1.f : l_b);

    // pass 2: o += round(exp(s - lse)) @ v, no rescale and no division;
    // with SAVE also o2 += bf16(exp(s - lse)) @ v
    float o2[SAVE ? NO : 1];
#pragma unroll
    for (int i = 0; i < (SAVE ? NO : 1); ++i) o2[i] = 0.f;
    cp_async_wait<0>();
    __syncthreads();  // every warpgroup is done with pass 1's stages
    for (int j = 0; j < NSTAGE - 1; ++j) issue(j, true);
    for (int j = 0; j < n_tiles; ++j) {
      arrive();
      issue(j + NSTAGE - 1, true);
      const int k0 = j * BK;
      if (k0 >= wg_kend) continue;
      scores<D, true>(s, q_s, stage(j), wg);
      if (edge(k0)) exp_lse<true>(s, scale, m_a, m_b, pos, k0);
      else exp_lse<false>(s, scale, m_a, m_b, pos, k0);
      PFrag a, a2;
      if constexpr (SAVE) pack_frag(a2, s);
      qt_round_all<true>(s, p_fmt);
      pack_frag(a, s);
      fence_regs(a);
      fence_regs(o_acc);
      if constexpr (SAVE) {
        fence_regs(a2);
        fence_regs(o2);
      }
      wg_fence();
      wgmma_rs_tile<BK>(o_acc, a, stage(j) + L::KV_BYTES);
      if constexpr (SAVE) wgmma_rs_tile<BK>(o2, a2, stage(j) + L::KV_BYTES);
      wg_commit_wait();
      fence_regs(a);
      fence_regs(o_acc);
      if constexpr (SAVE) {
        fence_regs(a2);
        fence_regs(o2);
      }
    }
    if constexpr (SAVE)
      store_rows(o_unq + bh * S * D, o2, q0 + row_a, S, pos.col0);
#pragma unroll
    for (int i = 0; i < NO; ++i) o_acc[i] = round_bf16(o_acc[i]);
    qt_round_all<true>(o_acc, out_fmt);
  }

  store_rows(o + bh * S * D, o_acc, q0 + row_a, S, pos.col0);
  if (lse_out != nullptr && (lane & 3) == 0) {
    if (q0 + row_a < S) lse_out[bh * S + q0 + row_a] = m_a;
    if (q0 + row_a + 8 < S) lse_out[bh * S + q0 + row_a + 8] = m_b;
  }
}

template <int D, bool TWO_PASS, bool SAVE>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           void* o_unq, int B, int H, int KV, int S, int T, float scale,
           int causal, int q_offset, QtFormat p_fmt, QtFormat out_fmt,
           void* stream) {
  auto kern = flash_fwd<D, TWO_PASS, SAVE>;
  constexpr int smem = Layout<D>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out),
      static_cast<float*>(lse), static_cast<uint16_t*>(o_unq), H, KV, S, T,
      scale, causal, q_offset, p_fmt, out_fmt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, H, S, D), k/v (B, KV, T, D), out (B, H, S, D): contiguous bf16,
// 16-byte aligned; H % KV == 0; D in {64, 128}.  lse: f32 (B, H, S), or
// null (inference).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int KV, int S, int T, int D,
                   float scale, int causal, int q_offset, void* stream) {
  const QtFormat none{};
  if (D == 128)
    return launch<128, false, false>(q, k, v, out, lse, nullptr, B, H, KV, S,
                                     T, scale, causal, q_offset, none, none,
                                     stream);
  if (D == 64)
    return launch<64, false, false>(q, k, v, out, lse, nullptr, B, H, KV, S,
                                    T, scale, causal, q_offset, none, none,
                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_attn_fwd, with p rounded to p_fmt and the output to out_fmt
// (kind QT_NONE: no output rounding).  lse and o_unq (bf16, as out) are
// both null (inference) or both set (training).
int flash_attn_fwd_two_pass(const void* q, const void* k, const void* v,
                            void* out, void* lse, void* o_unq, int B, int H,
                            int KV, int S, int T, int D, float scale,
                            int causal, int q_offset, QtFormat p_fmt,
                            QtFormat out_fmt, void* stream) {
  if ((lse == nullptr) != (o_unq == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define QT_TWO_PASS(DD, SV)                                                  \
  return launch<DD, true, SV>(q, k, v, out, lse, o_unq, B, H, KV, S, T,      \
                              scale, causal, q_offset, p_fmt, out_fmt, stream)
  if (D == 128) {
    if (lse) QT_TWO_PASS(128, true);
    QT_TWO_PASS(128, false);
  }
  if (D == 64) {
    if (lse) QT_TWO_PASS(64, true);
    QT_TWO_PASS(64, false);
  }
#undef QT_TWO_PASS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
