// One decode step of attention over the KIVI two-tier cache: a main tier of
// group-affine codes plus a bf16 residual ring.
//   q (B, H, D) bf16; k/v codes (B, KV, P*BITS/32, D) int32 token-planar
//   words (bit field s of word row t' holds the centered code c - 2^(BITS-1)
//   of token s*(P*BITS/32) + t') or, BITS = 0, (B, KV, P, D) uint8 codes;
//   k scale/zp (B, KV, P/bsK, D) bf16 (K grouped along tokens); v scale/zp
//   (B, KV, P, D/bsV) bf16 (V grouped along features); k/v residual
//   (B, KV, R, D) bf16; main_len/res_len (B,) int32.  Out (B, H, D) bf16.
// With c' the centered code (the raw code when BITS = 0, mid = 0 then):
//   qb = bf16(q * scale)
//   s[t] = qb . bf16(c'_k[t] * ks[g(t)]) + bf16(qb . bf16((mid - kz[g]) ks[g])),
//          t < main_len;   s_res[r] = qb . k_res[r],  r < res_len
//   one f32 softmax over both tiers; p of either tier rounded to bf16;
//   out = (sum_t p_t bf16(c'_v[t] * vs[t]) + bf16(sum_t p_t
//          bf16((mid - vz[t]) vs[t])) + sum_r p_r v_res[r]) / l,
// the rounding points of the TPU kernel.
//
// Replaces quantized_training_tpu/ops/pallas/kivi_attention.py:76 (_kernel,
// reached through kivi_decode_attention), whose grid is one program per
// (batch, kv head) and whose group expansions are 0/1 matmuls on the MXU.
// Instantiated for G = H / KV in {1, 2, 4, 8} query heads per kv head and
// D in {64, 128}, each for uint2 and uint4 words and uint8 codes; query head
// h reads kv head h / G.
//
// What bounds it on an H100: the bytes of codes, qparams and residual ring
// over 3.35 TB/s, read once per kv head whatever G is (at 8 full slots, P =
// 2048, R = 128, uint2 codes: about 67 MB per layer for LLaMA-2 7B, KV = 32;
// about 21 MB or 6.3 us for Phi-3-medium, KV = 10, G = 4).  Every product
// runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums), with the
// codes dequantized in registers:
//   * S = Qb K^T: the G query heads are the 16 rows (padded), k the
//     features, n eight tokens.  Lane t of a quad holds the features
//     (D/4)t + 4c + 0..3 of k chunk c, so one 16-byte read of a word row
//     feeds it; lane group g holds token column g.  For packed words the
//     eight columns of an n8 tile are eight planes of one word row, so the
//     words a lane reads give its B fragments of every plane: for uint2 its
//     two tiles (planes (g>>1) + 8(g&1) and 4 more) come out of the same
//     four words, a byte permute (prmt) picking the half that holds them, a
//     shift and one LOP3 each pair of codes.  A field becomes bf16 128 + c
//     ((field & mask) ^ (0x4300 | mid)), minus 128 + mid is exactly c', and
//     one bf16x2 multiply by the scale rounds c' * ks once: khat and vhat
//     are the plain version's bf16 values bit for bit.  Bytes go through
//     f32 (2^23 + c from a prmt, minus 2^23, times the scale, one rounding).
//   * The K zero-point constant is one more product with the same A
//     fragment, B = bf16((mid - kz) ks) of the groups of the lane's tokens,
//     so its C fragment sits where the scores it joins sit; it and the K
//     scales stay in registers until a lane's group changes (once a warp
//     run at the flagship's bs = 32).  No table bounds the groups.
//   * p against the global max, as the TPU rounds it: the blocks of one
//     (batch, kv head) pair form a cluster (decode_attn.cuh).  Phase 1
//     streams K and keeps the scores in shared memory; the blocks meet
//     their maxima over distributed shared memory; phase 2 streams V.
//   * O^T = V^T P^T: the scores' C fragment layout is the B fragment of
//     P^T (FlashAttention-2's reuse), so each lane reads back only its own
//     scores; V^T is the A fragment, its rows the features (D/8)g + 2i
//     (+1) of m tile i, k the sixteen tokens of the step, which for uint2
//     words are planes t, t + 8 (tile 0) and t + 4, t + 12 (tile 1) of one
//     word row: one shift and one LOP3 give a pair of codes of one feature.
//     The V zero-point term is P W2 with W2 = bf16((mid - vz) vs), gD rows
//     padded to 16, on the same B fragment; it is summed over every token
//     and block and rounded to bf16 once, in the merge.
//   * The residual ring is bf16 already: its rows go straight into the B
//     and A fragments (a prmt pairs two tokens' values).
//   * Feeding: each warp streams its steps' code rows (and in phase 2 the
//     vs/vz rows of their tokens) through a cp.async ring of its own (16-,
//     8- or 4-byte copies; rows padded so that a quarter warp's 16-byte
//     reads hit distinct banks), waited on with __syncwarp.  The ring rows
//     are read straight from global memory, each phase's before its main
//     steps, while the ring fills; the first V steps are in flight before
//     the cluster meets its max.
//   * The grid is (splits, KV, B), one cluster of `splits` blocks a pair:
//     kivi_decode_plan (ops/kivi_attention.py) picks it so that the grid
//     runs in one wave (2 blocks a pair at the 7B shape, 512 in all at four
//     blocks an SM; 4 at Phi-3's, 320), and the 4 * splits warps of a pair
//     share each tier's steps evenly.  Each block adds the blocks' partials
//     of its share of the outputs in rank order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_attn.cuh"

namespace {

using namespace dattn;

// The tier's geometry for one cache form.
template <int D, int BITS>
struct Geo {
  static constexpr int PER = BITS ? 32 / BITS : 1;   // tokens a row
  static constexpr int SR = BITS ? 16 / PER : 16;     // rows a step
  static constexpr int ROWB = BITS ? 4 * D : D;       // bytes of a row
  // bytes of a row in a ring stage: packed rows get 16 bytes after every
  // 128, byte rows 16 at their end, so that a quarter warp's reads spread
  // over the banks
  static constexpr int SROW = BITS ? ROWB + ROWB / 8 : ROWB + 16;
  static constexpr int CODES = SR * SROW;             // K (or V) of a step
  static constexpr int STAGES = BITS == 4 ? 6 : 4;    // ring slots a warp
  static constexpr int MID = BITS ? 1 << (BITS - 1) : 0;
};

struct Args {
  const uint16_t* q;
  const void* kc;
  const uint16_t* ks;
  const uint16_t* kz;
  const void* vc;
  const uint16_t* vs;
  const uint16_t* vz;
  const uint16_t* kr;
  const uint16_t* vr;
  const int32_t* main_len;
  const int32_t* res_len;
  uint16_t* out;
  int KV, P, R, gP, gD, bsK, bsV, bsk_shift;
  int stage_bytes;  // one ring stage: codes, then (phase 2) vs and vz rows
  int region0;      // bytes of the rings (then the partials)
  int max_steps;    // most steps a warp takes (its scores' room)
  int qp_chunk;     // bytes a qparam copy: 8, 4, or 2 (plain loads)
  float scale;
  // held in registers so that each LOP3 takes them as operands
  uint32_t mask;    // a field in both halves
  uint32_t magic;   // 0x4300 | mid in both halves: bf16 128 + c
  uint32_t bias;    // bf16x2 of 128 + mid
  uint32_t fmagic;  // 0x4b000000: f32 2^23 + byte
};

__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// bf16(c' * s) of the fields in bits [0, BITS) and [16, 16 + BITS) of x
// (two's complement centered codes), s a bf16x2 scale pair: exact c' from
// the magic number, one rounding of the product.
__device__ __forceinline__ uint32_t deq_fields(uint32_t x, uint32_t s,
                                               uint32_t mask, uint32_t magic,
                                               uint32_t bias) {
  return bmul2(bsub2((x & mask) ^ magic, bias), s);
}

// Byte J of w as an f32 (exact).
template <int J>
__device__ __forceinline__ float byte_f32(uint32_t w, uint32_t fmagic) {
  return __uint_as_float(prmt(w, fmagic, 0x7440 | J)) - 8388608.0f;
}

__device__ __forceinline__ uint32_t deq_bytes(float c0, float c1, float s0,
                                              float s1) {
  return pack_bf16(c0 * s0, c1 * s1);
}

// Token of column n of n8 tile x in the step whose first row is w (Pw word
// rows a plane), and the row it lives in.
template <int BITS>
__device__ __forceinline__ int step_token(int x, int n, int w, int Pw) {
  if (BITS == 2) return ((n >> 1) + 8 * (n & 1) + 4 * x) * Pw + w;
  if (BITS == 4) return ((n >> 1) + 4 * (n & 1)) * Pw + w + x;
  return w + 8 * x + n;
}

template <int BITS>
__device__ __forceinline__ int step_row(int x, int n, int w) {
  return BITS == 2 ? w : BITS == 4 ? w + x : w + 8 * x + n;
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Stage byte offset of word f of a packed row (16 bytes after every 128).
__device__ __forceinline__ int word_off(int f) { return 4 * f + 16 * (f >> 5); }

// Blocks an SM that the launch bounds ask for: four (at most 128 registers,
// so that the 7B shape's 2 blocks a pair run in one wave) where ptxas fits
// the form without spilling, else what it needs.  kivi_decode_blocks_per_sm
// reports the occupancy to the plan (ops/kivi_attention.py).
template <int D, int G, int BITS>
constexpr int min_blocks() {
  return BITS && D == 128 && G <= 2 ? 4 : 1;
}

template <int D, int G, int BITS>
__global__ void __launch_bounds__(THREADS, (min_blocks<D, G, BITS>()))
kivi_mma(const Args a) {
  using F = Geo<D, BITS>;
  constexpr int KC = D / 16;  // k chunks of S, m tiles of O^T
  constexpr int FL = D / 8;   // O^T features of a lane
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int H = a.KV * G;
  const size_t bk = static_cast<size_t>(b) * a.KV + kvh;
  const int P = a.P, R = a.R, gD = a.gD;
  const int ml = min(max(a.main_len[b], 0), P);
  const int rl = min(max(a.res_len[b], 0), R);
  const int Pw = P / F::PER;  // rows of the main tier
  const uint32_t mask = a.mask, magic = a.magic, bias = a.bias;
  const uint32_t fmagic = a.fmagic;

  // this warp's steps of each tier, and its rows, cut at what is visible
  // (rows at or past main_len hold no visible token: row t' of plane 0 is
  // token t')
  const int W = WARPS * splits, wi = split * WARPS + warp;
  int m0, m1, q0, q1;
  warp_steps(wi, W, cdiv(Pw, F::SR), m0, m1);
  warp_steps(wi, W, cdiv(R, STEP), q0, q1);
  const int r0 = m0 * F::SR, r1 = min(min(m1 * F::SR, Pw), ml);
  const int e0 = q0 * STEP, e1 = min(min(q1 * STEP, R), rl);
  const int nmain = r1 > r0 ? cdiv(r1 - r0, F::SR) : 0;
  const int nres = e1 > e0 ? cdiv(e1 - e0, STEP) : 0;

  // shared memory: the rings (then the partials), the scores, the maxima
  uint8_t* ring = smem + warp * F::STAGES * a.stage_bytes;
  float* scores = reinterpret_cast<float*>(smem + a.region0) +
                  warp * a.max_steps * STEP * G;
  float* wmax = reinterpret_cast<float*>(smem + a.region0) +
                WARPS * a.max_steps * STEP * G;
  float* bmax = wmax + WARPS * G;
  const uint8_t* kcode = static_cast<const uint8_t*>(a.kc) + bk * Pw * F::ROWB;
  const uint8_t* vcode = static_cast<const uint8_t*>(a.vc) + bk * Pw * F::ROWB;

  // step i's code rows into its ring slot (K in phase 1, V in phase 2);
  // rows past the run are zero
  auto issue_codes = [&](const uint8_t* code, int i) {
    const int w = r0 + i * F::SR;
    const uint32_t s_st = smem_u32(ring + (i % F::STAGES) * a.stage_bytes);
    constexpr int CH = F::ROWB / 16;
#pragma unroll
    for (int idx = lane; idx < F::SR * CH; idx += 32) {
      const int rr = idx / CH, ch = idx % CH;
      const int row = w + rr;
      const bool ok = row < r1;
      const size_t off = static_cast<size_t>(ok ? row : r0) * F::ROWB + 16 * ch;
      cp_async16(s_st + rr * F::SROW + 16 * ch + (BITS ? 16 * (ch >> 3) : 0),
                 code + off, ok);
    }
  };

  // ================= phase 1: S = Qb K^T into shared memory ================
  float mloc = -INFINITY;  // lane's max over head g's visible scores
  {
    // the ring fills while q and the first K groups load
#pragma unroll
    for (int s = 0; s < F::STAGES - 1; ++s) {
      if (s < nmain) issue_codes(kcode, s);
      cp_async_commit();
    }
    // qb = bf16(q * scale): A fragments of S, lane t's features (D/4)t + 4c
    // + j at k 2t, 2t + 1 (j = 0, 1) and 2t + 8, 2t + 9 (j = 2, 3); rows
    // past G (and the padding rows 8-15) zero
    uint32_t qa[KC][2];  // a0 and a2 (a1 and a3, rows 8-15, are zero)
    {
      const uint16_t* qp = a.q + (static_cast<size_t>(b) * H + kvh * G +
                                  min(g, G - 1)) * D + (D / 4) * t;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const uint2 v = *reinterpret_cast<const uint2*>(qp + 4 * c);
        qa[c][0] = g < G ? pack_bf16(bf16_lo(v.x) * a.scale,
                                     bf16_hi(v.x) * a.scale) : 0u;
        qa[c][1] = g < G ? pack_bf16(bf16_lo(v.y) * a.scale,
                                     bf16_hi(v.y) * a.scale) : 0u;
      }
    }
    // head g's scores of step j: columns 2t + e of tile x at
    // scores[(j * G + g) * 16 + 8x + 2t + e]
    auto keep = [&](int j, const float (&sv)[2][2]) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mloc = fmaxf(mloc, fmaxf(sv[x][0], sv[x][1]));
        if (g < G)
          *reinterpret_cast<float2*>(scores + (j * G + g) * STEP + 8 * x + 2 * t) =
              make_float2(sv[x][0], sv[x][1]);
      }
    };

    // the half of a word pair that holds lane g's planes, and their shift
    const uint32_t sel_k = (g & 1) ? 0x7632u : 0x5410u;
    const int sh_k = BITS == 2 ? 2 * (g >> 1) : 4 * (g >> 1);
    // K state of lane g's two token columns: their groups, scales (bf16
    // pairs of lane t's features) and zero-point constants (C fragment)
    int kg0 = -1, kg1 = -1;
    uint32_t ksc[2][KC][2];
    float kcon[2][2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      kcon[x][0] = kcon[x][1] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) ksc[x][c][0] = ksc[x][c][1] = 0u;
    }

    // the K groups of lane g's columns in the step whose first row is w
    auto groups_of = [&](int w, int (&ng)[2]) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int tok = min(step_token<BITS>(x, g, w, Pw), P - 1);
        ng[x] = a.bsk_shift >= 0 ? tok >> a.bsk_shift : tok / a.bsK;
      }
    };
    // their scales and zero-point constants: W1 = bf16((mid - kz) ks) as
    // the B fragment of the same product as the scores'
    auto load_groups = [&](const int (&ng)[2]) {
      kg0 = ng[0];
      kg1 = ng[1];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const size_t row = (bk * a.gP + ng[x]) * D + (D / 4) * t;
        const uint4* sp = reinterpret_cast<const uint4*>(a.ks + row);
        const uint4* zp = reinterpret_cast<const uint4*>(a.kz + row);
        float cacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c2 = 0; c2 < KC / 2; ++c2) {
          const uint4 sv = sp[c2], zv = zp[c2];
          const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
          const uint32_t zw[4] = {zv.x, zv.y, zv.z, zv.w};
          uint32_t w1[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ksc[x][2 * c2 + j / 2][j % 2] = sw[j];
            w1[j] = pack_bf16(
                __fmul_rn(__fsub_rn(float(F::MID), bf16_lo(zw[j])),
                          bf16_lo(sw[j])),
                __fmul_rn(__fsub_rn(float(F::MID), bf16_hi(zw[j])),
                          bf16_hi(sw[j])));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t* qc = qa[2 * c2 + h];
            mma_bf16(cacc, qc[0], 0u, qc[1], 0u, w1[2 * h], w1[2 * h + 1]);
          }
        }
        kcon[x][0] = round_bf16(cacc[0]);
        kcon[x][1] = round_bf16(cacc[1]);
      }
    };
    // ---- the residual ring: bf16 rows straight into the B fragments, while
    // the ring fills ---------------------------------------------------------
    const uint16_t* krp = a.kr + bk * R * D;
    for (int i = 0; i < nres; ++i) {
      const int w = e0 + i * STEP;
      float sacc[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = w + 8 * x + g;
        const uint4* kp = reinterpret_cast<const uint4*>(
            krp + static_cast<size_t>(row < e1 ? row : w) * D + (D / 4) * t);
        uint4 kv[D / 32];
#pragma unroll
        for (int q4 = 0; q4 < D / 32; ++q4)
          kv[q4] = row < e1 ? kp[q4] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[x][e] = 0.f;
#pragma unroll
        for (int c = 0; c < KC; ++c)
          mma_bf16(sacc[x], qa[c][0], 0u, qa[c][1], 0u,
                   (c & 1) ? kv[c / 2].z : kv[c / 2].x,
                   (c & 1) ? kv[c / 2].w : kv[c / 2].y);
      }
      float sv[2][2];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sv[x][e] = w + 8 * x + 2 * t + e < e1 ? sacc[x][e] : -INFINITY;
      keep(i, sv);
    }
    if (nmain > 0) {
      int ng[2];
      groups_of(r0, ng);
      load_groups(ng);
    }

    for (int i = 0; i < nmain; ++i) {
      cp_async_wait<F::STAGES - 2>();
      __syncwarp();  // step i has landed in every lane; the slot of step
                     // i + STAGES - 1 is free
      if (i + F::STAGES - 1 < nmain) issue_codes(kcode, i + F::STAGES - 1);
      cp_async_commit();
      const uint8_t* st = ring + (i % F::STAGES) * a.stage_bytes;
      const int w = r0 + i * F::SR;

      // ---- the K groups of lane g's columns -----------------------------
      {
        int ng[2];
        groups_of(w, ng);
        if (__any_sync(0xffffffffu, ng[0] != kg0 || ng[1] != kg1))
          load_groups(ng);
      }

      float sacc[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[x][e] = 0.f;
      if constexpr (BITS == 0) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint8_t* kp = st + (8 * x + g) * F::SROW + (D / 4) * t;
#pragma unroll
          for (int c4 = 0; c4 < KC / 4; ++c4) {
            const uint4 kw = lds128(kp + 16 * c4);
            const uint32_t ww[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int c = 4 * c4 + cc;
              const uint32_t s01 = ksc[x][c][0], s23 = ksc[x][c][1];
              const uint32_t b0 = deq_bytes(byte_f32<0>(ww[cc], fmagic),
                                            byte_f32<1>(ww[cc], fmagic),
                                            bf16_lo(s01), bf16_hi(s01));
              const uint32_t b1 = deq_bytes(byte_f32<2>(ww[cc], fmagic),
                                            byte_f32<3>(ww[cc], fmagic),
                                            bf16_lo(s23), bf16_hi(s23));
              mma_bf16(sacc[x], qa[c][0], 0u, qa[c][1], 0u, b0, b1);
            }
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int f = (D / 4) * t + 4 * c;
          if constexpr (BITS == 2) {
            // both tiles (planes (g>>1) + 8(g&1) and 4 more) from one read
            const uint4 kw = lds128(st + word_off(f));
            const uint32_t z01 = prmt(kw.x, kw.y, sel_k);
            const uint32_t z23 = prmt(kw.z, kw.w, sel_k);
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int sh = sh_k + 8 * x;
              mma_bf16(sacc[x], qa[c][0], 0u, qa[c][1], 0u,
                       deq_fields(z01 >> sh, ksc[x][c][0], mask, magic, bias),
                       deq_fields(z23 >> sh, ksc[x][c][1], mask, magic, bias));
            }
          } else {
#pragma unroll
            for (int x = 0; x < 2; ++x) {  // plane (g>>1) + 4(g&1) of row x
              const uint4 kw = lds128(st + x * F::SROW + word_off(f));
              const uint32_t z01 = prmt(kw.x, kw.y, sel_k);
              const uint32_t z23 = prmt(kw.z, kw.w, sel_k);
              mma_bf16(sacc[x], qa[c][0], 0u, qa[c][1], 0u,
                       deq_fields(z01 >> sh_k, ksc[x][c][0], mask, magic, bias),
                       deq_fields(z23 >> sh_k, ksc[x][c][1], mask, magic, bias));
            }
          }
        }
      }
      float sv[2][2];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * t + e;
          const bool vis = step_row<BITS>(x, n, w) < r1 &&
                           step_token<BITS>(x, n, w, Pw) < ml;
          sv[x][e] = vis ? sacc[x][e] + kcon[x][e] : -INFINITY;
        }
      keep(nres + i, sv);
    }
    cp_async_wait<0>();
  }

  // ================= phase 2: O^T = V^T P^T, then P W2 =======================
  float l = 0.f, m = -INFINITY;  // head g's sum of p; the pair's max
  float oacc[KC][4], acc2[2][4];
#pragma unroll
  for (int i = 0; i < KC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[i][e] = 0.f;
  // step j's p of head g as the B fragment of P^T (lanes past G: zero)
  auto p_of = [&](int j, uint32_t (&pb)[2]) {
    float sv[2][2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float2 v = make_float2(-INFINITY, -INFINITY);
      if (g < G)
        v = *reinterpret_cast<const float2*>(scores + (j * G + g) * STEP +
                                             8 * x + 2 * t);
      sv[x][0] = v.x;
      sv[x][1] = v.y;
    }
    p_frags(sv, m, l, pb);
  };
  {
    const uint16_t* vsg = a.vs + bk * P * gD;
    const uint16_t* vzg = a.vz + bk * P * gD;
    // V codes, then the step's 16 tokens' vs and vz rows (slot k = 8x + n:
    // column n of tile x): lane (k, arr) = (lane / 2, lane % 2) copies its
    // row of vs (arr 0) or vz (arr 1) in qp_chunk-byte pieces
    const int qk = lane >> 1, qx = qk >> 3, qn = qk & 7;
    const uint16_t* qsrc = ((lane & 1) ? vzg : vsg) +
                           static_cast<size_t>(step_token<BITS>(qx, qn, 0, Pw)) * gD;
    const int qdst = F::CODES + 2 * ((lane & 1) * 16 + qk) * gD;
    const int cs = a.qp_chunk, cpr = 2 * gD / cs;
    auto issue = [&](int i) {
      issue_codes(vcode, i);
      const int w = r0 + i * F::SR;
      uint8_t* st = ring + (i % F::STAGES) * a.stage_bytes;
      const uint32_t s_st = smem_u32(st) + qdst;
      const bool ok = step_row<BITS>(qx, qn, w) < r1;
      const uint16_t* src = qsrc + static_cast<size_t>(ok ? w : 0) * gD;
      if (cs == 8) {
        for (int ch = 0; ch < cpr; ++ch) cp_async8(s_st + 8 * ch, src + 4 * ch, ok);
      } else if (cs == 4) {
        for (int ch = 0; ch < cpr; ++ch) cp_async4(s_st + 4 * ch, src + 2 * ch, ok);
      } else {
        for (int ch = 0; ch < cpr; ++ch)
          reinterpret_cast<uint16_t*>(st + qdst)[ch] = ok ? src[ch] : 0;
      }
    };
    // the first V steps are in flight while the cluster meets its max
    __syncwarp();
#pragma unroll
    for (int s = 0; s < F::STAGES - 1; ++s) {
      if (s < nmain) issue(s);
      cp_async_commit();
    }
    mloc = quad_max(mloc);
    if (t == 0 && g < G) wmax[warp * G + g] = mloc;
    m = cluster_max<G>(wmax, bmax, splits);
    // ---- the residual ring first, while the ring fills ------------------
    const uint16_t* vrp = a.vr + bk * R * D;
    for (int i = 0; i < nres; ++i) {
      const int w = e0 + i * STEP;
      uint4 vv[2][2][FL / 8];  // rows w + 8x + 2t + e, lane g's FL values
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = w + 8 * x + 2 * t + e;
          const uint4* vp = reinterpret_cast<const uint4*>(
              vrp + static_cast<size_t>(row < e1 ? row : w) * D + FL * g);
#pragma unroll
          for (int q4 = 0; q4 < FL / 8; ++q4)
            vv[x][e][q4] = row < e1 ? vp[q4] : make_uint4(0u, 0u, 0u, 0u);
        }
      uint32_t pb[2];
      p_of(i, pb);
#pragma unroll
      for (int i2 = 0; i2 < KC; ++i2) {
        uint32_t af[2][2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint4 a4 = vv[x][0][i2 / 4], b4 = vv[x][1][i2 / 4];
          const uint32_t wa[4] = {a4.x, a4.y, a4.z, a4.w};
          const uint32_t wb[4] = {b4.x, b4.y, b4.z, b4.w};
          af[x][0] = prmt(wa[i2 % 4], wb[i2 % 4], 0x5410);  // feature 2i2
          af[x][1] = prmt(wa[i2 % 4], wb[i2 % 4], 0x7632);  // feature 2i2 + 1
        }
        mma_bf16(oacc[i2], af[0][0], af[0][1], af[1][0], af[1][1], pb[0], pb[1]);
      }
    }
    // the shifts of lane t's V pairs; lane g's V scale groups
    const int sh_v = BITS * t;
    int vsi[4];  // vs index of lane g's feature sub-block k (D/32 features)
#pragma unroll
    for (int k = 0; k < 4; ++k) vsi[k] = (FL * g + (D / 32) * k) / a.bsV;
    const bool vg1 = vsi[3] == vsi[0];

    for (int i = 0; i < nmain; ++i) {
      cp_async_wait<F::STAGES - 2>();
      __syncwarp();
      if (i + F::STAGES - 1 < nmain) issue(i + F::STAGES - 1);
      cp_async_commit();
      const uint8_t* st = ring + (i % F::STAGES) * a.stage_bytes;
      uint32_t pb[2];
      p_of(nres + i, pb);

      const uint16_t* vss = reinterpret_cast<const uint16_t*>(st + F::CODES);
      const uint16_t* vzs = vss + 16 * gD;
      uint32_t vsp[2][4];  // (vs of slot 8x + 2t, of 8x + 2t + 1) by sub-block
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const uint16_t* ra = vss + (8 * x + 2 * t) * gD;
        vsp[x][0] = ra[vsi[0]] | (static_cast<uint32_t>(ra[gD + vsi[0]]) << 16);
        vsp[x][1] = vsp[x][2] = vsp[x][3] = vsp[x][0];
      }
      if (!vg1) {  // warp-uniform: V groups narrower than a lane's features
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const uint16_t* ra = vss + (8 * x + 2 * t) * gD;
#pragma unroll
          for (int k = 1; k < 4; ++k)
            vsp[x][k] = ra[vsi[k]] | (static_cast<uint32_t>(ra[gD + vsi[k]]) << 16);
        }
      }
      if constexpr (BITS == 0) {
        uint32_t vb[2][2][FL / 4];  // rows 8x + 2t + e, lane g's FL bytes
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint8_t* vp = st + (8 * x + 2 * t + e) * F::SROW + FL * g;
            if constexpr (FL == 16) {
              const uint4 v4 = lds128(vp);
              vb[x][e][0] = v4.x;
              vb[x][e][1] = v4.y;
              vb[x][e][2] = v4.z;
              vb[x][e][3] = v4.w;
            } else {
              const uint2 v2 = *reinterpret_cast<const uint2*>(vp);
              vb[x][e][0] = v2.x;
              vb[x][e][1] = v2.y;
            }
          }
#pragma unroll
        for (int i2 = 0; i2 < KC; ++i2) {
          const int kk = (64 * i2) / D;
          uint32_t af[2][2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float sa = bf16_lo(vsp[x][kk]), sb = bf16_hi(vsp[x][kk]);
            const uint32_t wa = vb[x][0][i2 / 2], wb = vb[x][1][i2 / 2];
            if (i2 & 1) {
              af[x][0] = deq_bytes(byte_f32<2>(wa, fmagic), byte_f32<2>(wb, fmagic), sa, sb);
              af[x][1] = deq_bytes(byte_f32<3>(wa, fmagic), byte_f32<3>(wb, fmagic), sa, sb);
            } else {
              af[x][0] = deq_bytes(byte_f32<0>(wa, fmagic), byte_f32<0>(wb, fmagic), sa, sb);
              af[x][1] = deq_bytes(byte_f32<1>(wa, fmagic), byte_f32<1>(wb, fmagic), sa, sb);
            }
          }
          mma_bf16(oacc[i2], af[0][0], af[0][1], af[1][0], af[1][1], pb[0], pb[1]);
        }
      } else {
        uint32_t vw[2][FL];  // lane g's FL words of the step's row(s)
#pragma unroll
        for (int x = 0; x < (BITS == 4 ? 2 : 1); ++x)
#pragma unroll
          for (int q4 = 0; q4 < FL / 4; ++q4) {
            const uint4 v4 = lds128(st + x * F::SROW + word_off(FL * g + 4 * q4));
            vw[x][4 * q4] = v4.x;
            vw[x][4 * q4 + 1] = v4.y;
            vw[x][4 * q4 + 2] = v4.z;
            vw[x][4 * q4 + 3] = v4.w;
          }
#pragma unroll
        for (int i2 = 0; i2 < KC; ++i2) {
          const int kk = (64 * i2) / D;
          uint32_t af[2][2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            // uint2: tile x is planes t + 4x, t + 4x + 8 of the one row;
            // uint4: planes t, t + 4 of row x
            const int row = BITS == 4 ? x : 0;
            const int sh = BITS == 2 ? sh_v + 8 * x : sh_v;
            af[x][0] = deq_fields(vw[row][2 * i2] >> sh, vsp[x][kk], mask, magic, bias);
            af[x][1] = deq_fields(vw[row][2 * i2 + 1] >> sh, vsp[x][kk], mask, magic, bias);
          }
          mma_bf16(oacc[i2], af[0][0], af[0][1], af[1][0], af[1][1], pb[0], pb[1]);
        }
      }
      // W2 = bf16((mid - vz) vs): rows the V groups 16j + g (+ 8), k the
      // step's tokens
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (16 * j >= gD) break;  // warp-uniform
        uint32_t af[2][2];
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int fg = 16 * j + 8 * h + g;
            const int fc = min(fg, gD - 1);
            float w2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int o = (8 * x + 2 * t + e) * gD + fc;
              w2[e] = fg < gD ? __fmul_rn(__fsub_rn(float(F::MID),
                                                    bf16_lo(vzs[o])),
                                          bf16_lo(vss[o]))
                              : 0.f;
            }
            af[x][h] = pack_bf16(w2[0], w2[1]);
          }
        mma_bf16(acc2[j], af[0][0], af[0][1], af[1][0], af[1][1], pb[0], pb[1]);
      }
    }
    cp_async_wait<0>();
  }
  // ---- the warps' partials, then the merge ---------------------------------
  const int rec = 1 + D + gD;
  const float lh = quad_sum(l);
  __syncthreads();  // every ring is free
  float* warps = reinterpret_cast<float*>(smem);
  float* wp = warps + warp * G * rec;
  if (t == 0 && g < G) wp[g * rec] = lh;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int h = 2 * t + x;
    if (h < G) {
      float* r = wp + h * rec + 1;
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        r[FL * g + 2 * i] = oacc[i][x];
        r[FL * g + 2 * i + 1] = oacc[i][2 + x];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int fg = 16 * j + 8 * hh + g;
          if (fg < gD) r[D + fg] = acc2[j][2 * hh + x];
        }
    }
  }
  cluster_finish<G, D, EXTRA_BF16>(
      warps, warps + WARPS * G * rec, rec, a.bsV, 0.f, splits,
      a.out + (static_cast<size_t>(b) * H + kvh * G) * D);
}

// The launch's shared memory: the rings (or the warps' and the block's
// partials, whichever is larger), each warp's scores, the maxima.
template <int D, int BITS>
void layout(Args& a, int G, int splits) {
  using F = Geo<D, BITS>;
  a.stage_bytes = F::CODES + ((64 * a.gD + 15) / 16) * 16;
  const int W = WARPS * splits;
  a.max_steps = cdiv(cdiv(a.P / F::PER, F::SR), W) + cdiv(cdiv(a.R, STEP), W);
  const int ring = WARPS * F::STAGES * a.stage_bytes;
  const int parts = (WARPS + 1) * G * (1 + D + a.gD) * 4;
  a.region0 = ((ring > parts ? ring : parts) + 15) / 16 * 16;
}

size_t smem_bytes(const Args& a, int G) {
  return static_cast<size_t>(a.region0) +
         static_cast<size_t>(WARPS) * a.max_steps * STEP * G * 4 +
         static_cast<size_t>(WARPS + 1) * G * 4;
}

template <int D, int G, int BITS>
int launch(const Args& a, int B, int splits, cudaStream_t st) {
  const size_t smem = smem_bytes(a, G);
  if (smem > static_cast<size_t>(MAX_SMEM))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t cap = allow_smem<kivi_mma<D, G, BITS>>();
  if (cap != cudaSuccess) return static_cast<int>(cap);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.KV, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kivi_mma<D, G, BITS>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// bf16(c * s) of n (code, scale) pairs through the kernel's own dequant:
// packed codes (centered, two's complement fields) or bytes.
__global__ void dequant_check(const int32_t* __restrict__ codes,
                              const uint16_t* __restrict__ scales,
                              uint16_t* __restrict__ out, int n, int bits,
                              uint32_t mask, uint32_t magic, uint32_t bias,
                              uint32_t fmagic) {
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i + 1 >= n) return;
  const uint32_t s = scales[i] | (static_cast<uint32_t>(scales[i + 1]) << 16);
  uint32_t r;
  if (bits) {
    const uint32_t m = (1u << bits) - 1u;
    const uint32_t x = (static_cast<uint32_t>(codes[i]) & m) |
                       ((static_cast<uint32_t>(codes[i + 1]) & m) << 16);
    r = deq_fields(x, s, mask, magic, bias);
  } else {
    const uint32_t w = (static_cast<uint32_t>(codes[i]) & 255u) |
                       ((static_cast<uint32_t>(codes[i + 1]) & 255u) << 8);
    r = deq_bytes(byte_f32<0>(w, fmagic), byte_f32<1>(w, fmagic),
                  bf16_lo(s), bf16_hi(s));
  }
  out[i] = static_cast<uint16_t>(r);
  out[i + 1] = static_cast<uint16_t>(r >> 16);
}

struct Consts {
  uint32_t mask, magic, bias, fmagic;
};

Consts consts(int bits) {
  const uint32_t mid = bits ? 1u << (bits - 1) : 0u;
  const uint32_t m = bits ? (1u << bits) - 1u : 0u;
  // bf16 of 128 + mid: 0x4300 | mid (exact for mid < 128)
  return Consts{m | (m << 16), (0x4300u | mid) * 0x10001u,
                (0x4300u | mid) * 0x10001u, 0x4b000000u};
}

// The argument checks and launch arguments shared by kivi_decode and
// kivi_decode_smem; false where the kernel does not take the call.
bool make_args(Args& a, int B, int H, int KV, int D, int P, int R, int gP,
               int gD, int bits_k, int bits_v, int splits) {
  const int bits = bits_k;
  if (bits_k != bits_v || (bits != 0 && bits != 2 && bits != 4) || gP <= 0 ||
      gD <= 0 || KV <= 0 || B <= 0 || H % KV || P <= 0 || R < 0 || P % gP ||
      D % gD || (D / gD) % (D / 32) || gD > 32 || (bits && (P * bits) % 32) ||
      splits < 1 || splits > MAX_SPLITS)
    return false;
  const Consts k = consts(bits);
  a.KV = KV;
  a.P = P;
  a.R = R;
  a.gP = gP;
  a.gD = gD;
  a.bsK = P / gP;
  a.bsV = D / gD;
  a.bsk_shift = (a.bsK & (a.bsK - 1)) == 0
                    ? __builtin_ctz(static_cast<unsigned>(a.bsK)) : -1;
  a.qp_chunk = 2 * gD % 8 == 0 ? 8 : 2 * gD % 4 == 0 ? 4 : 2;
  a.mask = k.mask;
  a.magic = k.magic;
  a.bias = k.bias;
  a.fmagic = k.fmagic;
  const int G = H / KV;
  bool taken = with_dg(D, G, [&](auto d, auto) {
    constexpr int DD = decltype(d)::value;
    if (bits == 2) layout<DD, 2>(a, G, splits);
    else if (bits == 4) layout<DD, 4>(a, G, splits);
    else layout<DD, 0>(a, G, splits);
  });
  return taken;
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of shared memory a block of this launch needs (0 where the kernel
// does not take it; more than 227 KB: it refuses the call).
long long kivi_decode_smem(int B, int H, int KV, int D, int P, int R, int gP,
                           int gD, int bits, int splits) {
  Args a = {};
  if (!make_args(a, B, H, KV, D, P, R, gP, gD, bits, bits, splits)) return 0;
  return static_cast<long long>(smem_bytes(a, H / KV));
}

// Blocks of the kernel for (D, G, bits) that one SM holds at `smem` bytes
// of shared memory a block (0 where the kernel is not instantiated): what
// kivi_decode_plan needs to keep the grid in one wave.
int kivi_decode_blocks_per_sm(int D, int G, int bits, long long smem) {
  int n = 0;
  with_dg(D, G, [&](auto d, auto g) {
    constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
    auto occ = [&](auto form) {
      constexpr auto kernel = kivi_mma<DD, GG, decltype(form)::value>;
      allow_smem<kernel>();
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                    static_cast<size_t>(smem));
    };
    if (bits == 2) occ(std::integral_constant<int, 2>{});
    else if (bits == 4) occ(std::integral_constant<int, 4>{});
    else occ(std::integral_constant<int, 0>{});
  });
  return n;
}

// All tensors contiguous and 16-byte aligned.  D in {64, 128}, G = H / KV
// in {1, 2, 4, 8}; bits_k == bits_v in {0, 2, 4} (0: uint8 codes); P % gP
// == 0, D % gD == 0 and (D / gD) % (D / 32) == 0 (a V group spans whole D/32
// feature blocks), gD <= 32.  `splits` (1-8 blocks a (batch, kv head) pair,
// one cluster) is kivi_decode_plan's (ops/kivi_attention.py); a block's
// shared memory (kivi_decode_smem) must fit in 227 KB.
int kivi_decode(const void* q, const void* k_codes, const void* k_scale,
                const void* k_zp, const void* v_codes, const void* v_scale,
                const void* v_zp, const void* k_res, const void* v_res,
                const void* main_len, const void* res_len, void* out, int B,
                int H, int KV, int D, int P, int R, int gP, int gD,
                int bits_k, int bits_v, float scale, int splits,
                void* stream) {
  Args a = {};
  if (!make_args(a, B, H, KV, D, P, R, gP, gD, bits_k, bits_v, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = static_cast<const uint16_t*>(q);
  a.kc = k_codes;
  a.ks = static_cast<const uint16_t*>(k_scale);
  a.kz = static_cast<const uint16_t*>(k_zp);
  a.vc = v_codes;
  a.vs = static_cast<const uint16_t*>(v_scale);
  a.vz = static_cast<const uint16_t*>(v_zp);
  a.kr = static_cast<const uint16_t*>(k_res);
  a.vr = static_cast<const uint16_t*>(v_res);
  a.main_len = static_cast<const int32_t*>(main_len);
  a.res_len = static_cast<const int32_t*>(res_len);
  a.out = static_cast<uint16_t*>(out);
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bits = bits_k;
  int err = static_cast<int>(cudaErrorInvalidValue);
  with_dg(D, H / KV, [&](auto d, auto g) {
    constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
    err = bits == 2 ? launch<DD, GG, 2>(a, B, splits, st)
        : bits == 4 ? launch<DD, GG, 4>(a, B, splits, st)
                    : launch<DD, GG, 0>(a, B, splits, st);
  });
  return err;
}

// out = bf16(codes * scales) elementwise (n even) through the kernel's own
// dequant: bits 2 or 4, centered codes in [-2^(bits-1), 2^(bits-1)); bits 0,
// bytes in [0, 255].
int kivi_dequant_check(const void* codes, const void* scales, void* out,
                       int n, int bits, void* stream) {
  if (n <= 0 || n % 2 || (bits != 0 && bits != 2 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts k = consts(bits);
  const int threads = 256, pairs = n / 2;
  dequant_check<<<(pairs + threads - 1) / threads, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes), static_cast<const uint16_t*>(scales),
      static_cast<uint16_t*>(out), n, bits, k.mask, k.magic, k.bias,
      k.fmagic);
  return static_cast<int>(cudaGetLastError());
}


}  // extern "C"
