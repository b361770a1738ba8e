// One decode step of attention over the two-tier int4 or int8
// per-token-symmetric KV cache: a quantized main tier plus a bf16 residual
// ring.
//   q (B, H, D) bf16; k/v codes (B, KV, P/8, D) int32, token-planar: bit
//   field s of word row t' holds the 4-bit two's-complement code of token
//   s*(P/8) + t'; or (B, KV, P, D) int8 codes, one row per token; or, for
//   K in the K^T layout, (B, KV, D, P) int8; ks/vs (B, KV, 1, P) f32
//   per-token scales; k/v residual (B, KV, R, D) bf16; main_len/res_len
//   (B,) int32.  Out (B, H, D) bf16.
//   bf16 dots: qb = bf16(q * scale);  s_main[t] = (qb . c_k[t]) * ks[t],
//   t < main_len;  s_res[r] = qb . k_res[r], r < res_len;  one softmax over
//   both tiers;  out = (sum_t bf16(p_t * vs[t]) c_v[t]
//                       + sum_r bf16(p_r) v_res[r]) / l.
//   integer dots: qs = max(max|q * scale|, 1e-30) / 127 over the (group, D)
//   tile, q8 = rint(q * scale / qs); s_main[t] = (q8 . c_k[t]) * (ks[t] * qs)
//   exact in integers; after the softmax, ps = max(max|p * vs|, 1e-30) / 127
//   over the whole (group, P) tile, p8 = rint(p * vs / ps);
//   out = ((p8 . c_v) * ps + sum_r bf16(p_r) v_res[r]) / l.
//
// Replaces quantized_training_tpu/ops/pallas/int_kv_attention.py:77
// (_kernel, reached through int_kv_decode_attention) in all its forms, one
// kernel, int_kv_mma<FORM, D, G>: bits 4 with bf16 dots over untransposed
// words (I4, the served form), bits 8 with bf16 dots over untransposed rows
// (I8) or K^T (I8KT), integer dots over untransposed rows (ID) or K^T
// (IDKT).  Instantiated for G = H / KV in {1, 2, 4, 8} query heads per kv
// head and D in {64, 128}; query head h reads kv head h / G (the
// reference's q.reshape(B, KV, G, D)).
//
// What bounds it on an H100: the bytes of the codes, scales and residual
// ring over 3.35 TB/s, read once per kv head whatever G is.  At 8 full
// slots (P = 2048, R = 128) of one layer: LLaMA-2 7B (KV = 32) about 88 MB
// with int4 codes, 155 MB with int8; Phi-3-medium (KV = 10, G = 4) 27.5 MB
// with int4 codes, 48.6 MB with int8.  Every product runs on the tensor
// cores with mma.sync, the codes made into operands in registers:
//   * S = Q K^T: the G query heads are the 16 rows (padded; rows 8-15 are
//     zero and never held), k the features, n eight tokens.  bf16 dots
//     (m16n8k16, bf16 in, f32 sums): the codes become exact bf16 integers
//     and the token's scale multiplies the f32 dot afterwards, as the
//     reference multiplies.  int4: an n8 tile's columns are the 8 planes of
//     one word row (column n: plane n/2 + 4(n%2)), one prmt picks the half
//     of two words that holds a lane's plane, and one LOP3 and one bf16x2
//     subtraction give its two codes ((field ^ 8) | 0x4300 is bf16 128 + 8
//     + c); int8 bytes go through f32 (2^23 + 128 + c from a prmt, minus
//     2^23 + 128).  Integer dots (m16n8k32, s8 in, s32 sums): the code
//     bytes are the B fragment as stored; exact, like the TPU's s8 x s8 ->
//     s32.  Each lane's features follow the form's own order (`feat_b`,
//     `feat8`) so that its reads are whole 16-byte words or, in K^T, 4-byte
//     words of 4 tokens, transposed 4 x 4 with eight prmt into 4 features
//     of one token each (`transpose4`).
//   * p against the global max, as the TPU rounds it: the blocks of one
//     (batch, kv head) pair form a cluster (decode_attn.cuh).  Phase 1
//     keeps the scores in shared memory; the blocks meet their maxima over
//     distributed shared memory; phase 2 rounds bf16(p * vs) (main tier)
//     or bf16(p) (ring) into the B fragment of P^T and streams V.  The
//     integer dots first turn their scores into p * vs, meet the pair's
//     max of those as a second cluster max (ps), then round p8.
//   * O^T = V^T P^T: the scores' C fragment layout is the B fragment of
//     P^T, so each lane reads back only its own scores; V^T is the A
//     fragment, its rows the features (D/8)g + 2i (+1) of m tile i, k the
//     step's tokens.  int4: planes t and t + 4 of one word row are a k
//     pair, so one shift and one LOP3 give a pair of codes of one feature.
//     int8 rows: the lane's bytes of two tokens' rows, through f32, or, for
//     the integer dots (k32 of 4 tokens a register), four rows transposed
//     4 x 4.  The integer P V sums stay int32 across warps and blocks and
//     are converted to f32 once, then multiplied by ps (cluster_finish's
//     integer form), as the reference converts its int32 dot.
//   * The residual ring is bf16 already: its rows go straight into the B
//     and A fragments from global memory, before each phase's main steps.
//   * Feeding: a warp's share of the main tier is one contiguous run of
//     rows, so each warp streams it through a ring of its own in shared
//     memory by TMA bulk copies (cp.async.bulk, one a stage of one or two
//     steps; K^T: one 2-D copy of the D feature rows of two steps' 64
//     tokens, in TMA's 64-byte swizzle so that the transposes' 4-byte reads
//     spread over the banks), completed on an mbarrier a slot; the run's
//     scales go to shared memory by cp.async at each phase's start.
//     The first V stages are in flight before the cluster meets its max.
//   * The grid is (splits, KV, B), one cluster of `splits` blocks a pair:
//     int_kv_decode_plan (ops/int_kv_attention.py) picks it so that the grid
//     runs in one wave and a block's scores fit its shared memory, and the
//     4 * splits warps of a pair share each tier's steps evenly.  Each block
//     adds the blocks' partials of its share of the outputs in rank order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_attn.cuh"
#include "tma_pipe.cuh"  // mbarriers, TMA bulk copies

namespace {

using namespace dattn;

// The forms, numbered as the wrapper numbers them
// (ops/int_kv_attention.py:_form).
constexpr int I4 = 0, I8 = 1, I8KT = 2, ID = 3, IDKT = 4;

template <int FORM, int D>
struct Geo {
  static constexpr bool INT = FORM == ID || FORM == IDKT;  // integer dots
  static constexpr bool KT = FORM == I8KT || FORM == IDKT;
  static constexpr int PER = FORM == I4 ? 8 : 1;        // tokens a row
  static constexpr int NT = FORM == I4 || FORM == I8 ? 2 : 4;  // n8 tiles
  static constexpr int ST = 8 * NT;                      // tokens a step
  static constexpr int SR = ST / PER;                    // rows a step
  static constexpr int ROWB = FORM == I4 ? 4 * D : D;    // bytes a row
  static constexpr int SPS = FORM == I4 || KT ? 2 : 1;   // steps a stage
  static constexpr int KROW = SPS * ST;  // K^T: a feature row's bytes (64)
  static constexpr int KSTAGE = KT ? D * KROW : SPS * SR * ROWB;
  static constexpr int VSTAGE = SPS * SR * ROWB;
  static constexpr int STAGE = KSTAGE > VSTAGE ? KSTAGE : VSTAGE;
  static constexpr int STAGES = STAGE >= 4096 ? 2 : 4;   // ring slots a warp
  static constexpr int KC = D / 16;                      // bf16 k chunks
  static constexpr int FL = D / 8;                       // O^T features
  static constexpr int REC = 1 + (INT ? 2 : 1) * D;      // a head's partial
};

struct Args {
  const uint16_t* q;
  const uint8_t* kc;
  const float* ks;
  const uint8_t* vc;
  const float* vs;
  const uint16_t* kr;
  const uint16_t* vr;
  const int32_t* main_len;
  const int32_t* res_len;
  uint16_t* out;
  int KV, P, R;
  int max_main, max_res;  // most main and ring steps a warp takes
  int bar0, sbuf0, scores0, max0;  // byte offsets in shared memory
  int smem;                        // bytes of shared memory a block
  float scale;
  // held in registers so that each LOP3 takes them as operands
  uint32_t mask;   // a 4-bit field in both halves
  uint32_t magic;  // 0x4308 in both halves: bf16 128 + 8
};

__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// the int4 codes in bits [0, 4) and [16, 20) of x as an exact bf16 pair
__device__ __forceinline__ uint32_t deq4(uint32_t x, uint32_t mask,
                                         uint32_t magic) {
  return bsub2((x & mask) ^ magic, magic);
}

// byte J of w (its bytes XORed with 0x80: c + 128) as the f32 c, exact
template <int J>
__device__ __forceinline__ float sbyte(uint32_t wx) {
  return __uint_as_float(prmt(wx, 0x4b000000u, 0x7440 | J)) - 8388736.0f;
}

// bytes J and J2 of wx as a bf16 pair (exact)
template <int J, int J2>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t wx) {
  return pack_bf16(sbyte<J>(wx), sbyte<J2>(wx));
}

// byte J of wa and of wb as a bf16 pair (exact)
template <int J>
__device__ __forceinline__ uint32_t bf16_pair2(uint32_t wa, uint32_t wb) {
  return pack_bf16(sbyte<J>(wa), sbyte<J>(wb));
}

// rows w[0..3] of 4 bytes -> o[x]: byte x of each row, row i in byte i
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = prmt(w[0], w[1], 0x5140), t1 = prmt(w[2], w[3], 0x5140);
  const uint32_t t2 = prmt(w[0], w[1], 0x7362), t3 = prmt(w[2], w[3], 0x7362);
  o[0] = prmt(t0, t1, 0x5410);
  o[1] = prmt(t0, t1, 0x7632);
  o[2] = prmt(t2, t3, 0x5410);
  o[3] = prmt(t2, t3, 0x7632);
}

// d += A B, mma.sync m16n8k32, s8 in, s32 sums (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a / b rounded to nearest from r = RN(1/b), as div.rn rounds it: q =
// RN(a r) lies within an ulp of the quotient, the remainder a - q b is
// exact in one FMA, and one step q + (a - q b) r rounds to the correctly
// rounded quotient (Markstein), without div.rn's reciprocal and range
// checks for every value (p8's divisor ps is one a pair)
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, b, a), r, q);
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The feature of value r (k = 2t + r for r < 2, 2t + 8 + r - 2 else) of
// lane t in bf16 k chunk c (16 features): the order in which a lane reads
// its K codes whole.  The integer-dot forms' ring takes I4's order.
template <int FORM>
__device__ __forceinline__ int feat_b(int c, int t, int r) {
  if (FORM == I8) return 64 * (c >> 2) + 16 * t + 4 * (c & 3) + r;
  if (FORM == I8KT) return 32 * (c >> 1) + 2 * t + (c & 1) + 8 * r;
  return 16 * c + 4 * t + r;
}

// The feature of byte r (k = 4t + r for r < 4, 16 + 4t + r - 4 else) of lane
// t in integer k chunk c (32 features).
template <int FORM>
__device__ __forceinline__ int feat8(int c, int t, int r) {
  if (FORM == IDKT) return 32 * c + 2 * t + 8 * (r & 3) + (r >> 2);
  return 64 * (c >> 1) + 16 * t + 8 * (c & 1) + r;
}

// The step-local token of column n of n8 tile x (I4: its plane and row).
template <int FORM>
__device__ __forceinline__ int step_tok(int x, int n) {
  if (FORM == I8KT || FORM == IDKT) return 4 * n + x;
  return 8 * x + n;
}

// Blocks an SM that the launch bounds ask for: one, so that ptxas may take
// what registers a form needs without spilling; int_kv_decode_blocks_per_sm
// reports the occupancy to the plan (ops/int_kv_attention.py).
template <int FORM, int D, int G>
__global__ void __launch_bounds__(THREADS, 1)
int_kv_mma(const Args a, const __grid_constant__ CUtensorMap kt_map) {
  using F = Geo<FORM, D>;
  constexpr int KC = F::KC, FL = F::FL, NT = F::NT, ST = F::ST, SR = F::SR;
  extern __shared__ uint8_t smem_raw[];  // from the first 1024-byte line
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* const smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int H = a.KV * G;
  const size_t bk = static_cast<size_t>(b) * a.KV + kvh;
  const int P = a.P, R = a.R;
  const int ml = min(max(a.main_len[b], 0), P);
  const int rl = min(max(a.res_len[b], 0), R);
  const int Pw = P / F::PER;  // rows of the main tier
  const uint32_t mask = a.mask, magic = a.magic;

  // this warp's steps of each tier, and its rows, cut at what is visible
  // (rows at or past main_len hold no visible token: row t' of plane 0 is
  // token t')
  const int W = WARPS * splits, wi = split * WARPS + warp;
  int m0, m1, q0, q1;
  warp_steps(wi, W, cdiv(Pw, SR), m0, m1);
  warp_steps(wi, W, cdiv(R, STEP), q0, q1);
  const int r0 = m0 * SR, r1 = min(min(m1 * SR, Pw), ml);
  const int e0 = q0 * STEP, e1 = min(min(q1 * STEP, R), rl);
  const int nmain = r1 > r0 ? cdiv(r1 - r0, SR) : 0;
  const int nres = e1 > e0 ? cdiv(e1 - e0, STEP) : 0;
  const int nst = cdiv(nmain, F::SPS);  // ring stages of each phase
  const int nrow = nmain * SR;          // rows of the run's scale buffer

  // shared memory: the rings (later the partials), the ring's barriers, the
  // run's scales, the scores, the maxima
  uint8_t* ring = smem + warp * F::STAGES * F::STAGE;
  const uint32_t bars = smem_u32(smem + a.bar0) + warp * F::STAGES * 8;
  float* sbuf = reinterpret_cast<float*>(smem + a.sbuf0) + warp * a.max_main * ST;
  float* res_sc = reinterpret_cast<float*>(smem + a.scores0) +
                  warp * (a.max_main * ST + a.max_res * STEP) * G;
  float* main_sc = res_sc + a.max_res * STEP * G;
  float* wmax = reinterpret_cast<float*>(smem + a.max0);
  float* bmax = wmax + WARPS * G;
  float* wmax2 = bmax + G;
  float* bmax2 = wmax2 + WARPS * G;
  const uint8_t* kcode = a.kc + bk * Pw * F::ROWB;  // (K^T: by the map)
  const uint8_t* vcode = a.vc + bk * Pw * F::ROWB;

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < F::STAGES; ++s) mbar_init(bars + 8 * s, 1);
    fence_barrier_init();
  }
  __syncwarp();

  // stage k of a phase (K in phase 1, V in phase 2) into the slot of its
  // sequence number seq: the run's rows [w0, w1), one bulk copy; K^T, the
  // D feature rows of its tokens [w0, w0 + 64), one 2-D copy (tokens past P
  // read as zero)
  auto issue = [&](int seq, int k, bool v) {
    if (lane != 0) return;
    const int slot = seq % F::STAGES;
    const uint32_t dst = smem_u32(ring + slot * F::STAGE);
    const uint32_t bar = bars + 8 * slot;
    const int w0 = r0 + k * F::SPS * SR;
    const int w1 = min(w0 + F::SPS * SR, r1);
    if (F::KT && !v) {
      mbar_expect_tx(bar, F::KSTAGE);
      tma_load_2d(dst, &kt_map, w0, static_cast<int>(bk * D), bar);
    } else {
      const uint32_t nb = (w1 - w0) * F::ROWB;
      mbar_expect_tx(bar, nb);
      tma_load_1d(dst, (v ? vcode : kcode) + static_cast<size_t>(w0) * F::ROWB,
                  nb, bar);
    }
  };
  auto wait = [&](int seq) {
    mbar_wait(bars + 8 * (seq % F::STAGES), (seq / F::STAGES) & 1);
  };
  // the run's scales (ks, then vs): token p*Pw + row at p*nrow + row - r0
  auto load_scales = [&](const float* src) {
    const float* base = src + bk * P;
    for (int i = lane; i < nrow * F::PER; i += 32) {
      const int p = F::PER == 1 ? 0 : i / nrow;
      const int row = r0 + i - p * nrow;
      const bool ok = row < Pw;
      cp_async4(smem_u32(sbuf + i), base + (ok ? p * Pw + row : 0), ok);
    }
    cp_async_commit();
  };
  // the run's scale buffer index, row and token of column n of tile x of
  // main step j
  auto main_at = [&](int j, int x, int n, int& idx, int& row, int& tok) {
    if (FORM == I4) {
      const int plane = (n >> 1) + 4 * (n & 1);
      row = r0 + j * SR + x;
      tok = plane * Pw + row;
      idx = plane * nrow + row - r0;
    } else {
      idx = j * ST + step_tok<FORM>(x, n);
      row = tok = r0 + idx;
    }
  };

  // ================= phase 1: S = Q K^T into shared memory ==================
  for (int k = 0; k < F::STAGES && k < nst; ++k) issue(k, k, false);
  load_scales(a.ks);

  // qb = bf16(q * scale): A fragments of S for k chunk c (rows past G zero;
  // rows 8-15, a1 and a3, are zero and not held)
  const uint16_t* qh = a.q + (static_cast<size_t>(b) * H + kvh * G +
                              min(g, G - 1)) * D;
  uint32_t qa[KC][2];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = g < G ? __fmul_rn(__uint_as_float(static_cast<uint32_t>(
                                   qh[feat_b<FORM>(c, t, r)]) << 16),
                               a.scale)
                   : 0.f;
    qa[c][0] = pack_bf16(v[0], v[1]);
    qa[c][1] = pack_bf16(v[2], v[3]);
  }
  // integer dots: q8 = rint(q * scale / qs), qs over the (G, D) tile, which
  // each warp reduces itself
  float qs = 0.f;
  uint32_t q8[F::INT ? D / 32 : 1][2];
  if constexpr (F::INT) {
    const uint4* qt = reinterpret_cast<const uint4*>(
        a.q + (static_cast<size_t>(b) * H + kvh * G) * D);
    float amax = 0.f;
    for (int i = lane; i < G * D / 8; i += 32) {
      const uint4 v = qt[i];
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        amax = fmaxf(amax, fmaxf(fabsf(bf16_lo(w4[j])), fabsf(bf16_hi(w4[j]))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    qs = __fdiv_rn(fmaxf(__fmul_rn(amax, fabsf(a.scale)), 1e-30f), 127.f);
    const float rqs = __frcp_rn(qs);
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t w = 0u;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float qf = __fmul_rn(
              __uint_as_float(static_cast<uint32_t>(qh[feat8<FORM>(c, t, 4 * e + r)])
                              << 16),
              a.scale);
          const int q = g < G ? static_cast<int>(rintf(div_by(qf, qs, rqs))) : 0;
          w |= (static_cast<uint32_t>(q) & 0xffu) << (8 * r);
        }
        q8[c][e] = w;
      }
  }

  float mloc = -INFINITY;  // lane's max over head g's visible scores
  // ---- the residual ring: bf16 rows straight into the B fragments ---------
  const uint16_t* krp = a.kr + bk * R * D;
  for (int i = 0; i < nres; ++i) {
    const int w = e0 + i * STEP;
    float sacc[2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[x][e] = 0.f;
      const int row = w + 8 * x + g;
      const bool ok = row < e1;
      const uint16_t* rp = krp + static_cast<size_t>(ok ? row : w) * D;
      uint32_t kb[KC][2];
      if constexpr (FORM == I8) {
#pragma unroll
        for (int c4 = 0; c4 < D / 64; ++c4) {
          const uint4* p4 = reinterpret_cast<const uint4*>(rp + 64 * c4 + 16 * t);
          const uint4 v0 = p4[0], v1 = p4[1];
          kb[4 * c4][0] = v0.x; kb[4 * c4][1] = v0.y;
          kb[4 * c4 + 1][0] = v0.z; kb[4 * c4 + 1][1] = v0.w;
          kb[4 * c4 + 2][0] = v1.x; kb[4 * c4 + 2][1] = v1.y;
          kb[4 * c4 + 3][0] = v1.z; kb[4 * c4 + 3][1] = v1.w;
        }
      } else if constexpr (FORM == I8KT) {
#pragma unroll
        for (int C = 0; C < D / 32; ++C) {
          uint32_t L[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            L[r] = *reinterpret_cast<const uint32_t*>(rp + 32 * C + 2 * t + 8 * r);
          kb[2 * C][0] = prmt(L[0], L[1], 0x5410);
          kb[2 * C][1] = prmt(L[2], L[3], 0x5410);
          kb[2 * C + 1][0] = prmt(L[0], L[1], 0x7632);
          kb[2 * C + 1][1] = prmt(L[2], L[3], 0x7632);
        }
      } else {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const uint2 v = *reinterpret_cast<const uint2*>(rp + 16 * c + 4 * t);
          kb[c][0] = v.x;
          kb[c][1] = v.y;
        }
      }
#pragma unroll
      for (int c = 0; c < KC; ++c)
        mma_bf16(sacc[x], qa[c][0], 0u, qa[c][1], 0u, ok ? kb[c][0] : 0u,
                 ok ? kb[c][1] : 0u);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float2 sv;
      sv.x = w + 8 * x + 2 * t < e1 ? sacc[x][0] : -INFINITY;
      sv.y = w + 8 * x + 2 * t + 1 < e1 ? sacc[x][1] : -INFINITY;
      mloc = fmaxf(mloc, fmaxf(sv.x, sv.y));
      if (g < G)
        *reinterpret_cast<float2*>(res_sc + (i * G + g) * STEP + 8 * x + 2 * t) = sv;
    }
  }

  // ---- the main tier through the ring ---------------------------------------
  const uint32_t sel_k = (g & 1) ? 0x7632u : 0x5410u;  // I4: lane g's half
  const int sh_k = 4 * (g >> 1);                       // and its plane shift
  cp_async_wait<0>();
  __syncwarp();  // the ks of the run have landed in every lane
  for (int k = 0; k < nst; ++k) {
    wait(k);
    const uint8_t* st = ring + (k % F::STAGES) * F::STAGE;
#pragma unroll
    for (int s = 0; s < F::SPS; ++s) {
      const int j = k * F::SPS + s;
      if (j >= nmain) break;  // warp-uniform
      using Acc = typename std::conditional<F::INT, int, float>::type;
      Acc sacc[NT][4];
#pragma unroll
      for (int x = 0; x < NT; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[x][e] = 0;
      if constexpr (FORM == I4) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            const uint4 kw = lds128(st + (2 * s + x) * F::ROWB + 4 * (16 * c + 4 * t));
            const uint32_t z01 = prmt(kw.x, kw.y, sel_k);
            const uint32_t z23 = prmt(kw.z, kw.w, sel_k);
            mma_bf16(sacc[x], qa[c][0], 0u, qa[c][1], 0u,
                     deq4(z01 >> sh_k, mask, magic), deq4(z23 >> sh_k, mask, magic));
          }
      } else if constexpr (FORM == I8 || FORM == ID) {
#pragma unroll
        for (int x = 0; x < NT; ++x) {
          const uint8_t* kp = st + (s * ST + 8 * x + g) * D + 16 * t;
#pragma unroll
          for (int c4 = 0; c4 < D / 64; ++c4) {
            const uint4 kw = lds128(kp + 64 * c4);
            if constexpr (FORM == ID) {
              mma_s8(sacc[x], q8[2 * c4][0], 0u, q8[2 * c4][1], 0u, kw.x, kw.y);
              mma_s8(sacc[x], q8[2 * c4 + 1][0], 0u, q8[2 * c4 + 1][1], 0u,
                     kw.z, kw.w);
            } else {
              const uint32_t ww[4] = {kw.x ^ 0x80808080u, kw.y ^ 0x80808080u,
                                      kw.z ^ 0x80808080u, kw.w ^ 0x80808080u};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const int c = 4 * c4 + jj;
                mma_bf16(sacc[x], qa[c][0], 0u, qa[c][1], 0u,
                         bf16_pair<0, 1>(ww[jj]), bf16_pair<2, 3>(ww[jj]));
              }
            }
          }
        }
      } else {  // K^T: feature rows of the step's tokens, 4 x 4 transposes
        // (the 64-byte swizzle: 16-byte piece c of row r at c ^ (r / 2 % 4))
#pragma unroll
        for (int C = 0; C < D / 32; ++C) {
          uint32_t o[2][4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t wr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = 32 * C + 2 * t + e + 8 * i;
              const int c = (s * ST + 4 * g) >> 4;
              wr[i] = lds32(st + r * F::KROW + 16 * (c ^ ((r >> 1) & 3)) +
                            4 * (g & 3));
            }
            transpose4(wr, o[e]);
          }
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if constexpr (FORM == IDKT) {
              mma_s8(sacc[x], q8[C][0], 0u, q8[C][1], 0u, o[0][x], o[1][x]);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const uint32_t ox = o[e][x] ^ 0x80808080u;
                mma_bf16(sacc[x], qa[2 * C + e][0], 0u, qa[2 * C + e][1], 0u,
                         bf16_pair<0, 1>(ox), bf16_pair<2, 3>(ox));
              }
            }
          }
        }
      }
      // s = dot * ks (integer dots: * (ks * qs)); -inf where not visible
#pragma unroll
      for (int x = 0; x < NT; ++x) {
        float sv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int idx, row, tok;
          main_at(j, x, 2 * t + e, idx, row, tok);
          const float ksc = sbuf[idx];
          const bool vis = row < r1 && tok < ml;
          float v;
          if constexpr (F::INT)
            v = __fmul_rn(__int2float_rn(sacc[x][e]), __fmul_rn(ksc, qs));
          else
            v = __fmul_rn(sacc[x][e], ksc);
          sv[e] = vis ? v : -INFINITY;
        }
        mloc = fmaxf(mloc, fmaxf(sv[0], sv[1]));
        if (g < G)
          *reinterpret_cast<float2*>(main_sc + (j * G + g) * ST + 8 * x + 2 * t) =
              make_float2(sv[0], sv[1]);
      }
    }
    __syncwarp();  // every lane is done with the slot
    fence_proxy_async();
    if (k + F::STAGES < nst) issue(k + F::STAGES, k + F::STAGES, false);
  }

  // ================= phase 2: O^T = V^T P^T ==================================
  // the first V stages are in flight while the cluster meets its max
  for (int k = 0; k < F::STAGES && k < nst; ++k) issue(nst + k, k, true);
  load_scales(a.vs);
  mloc = quad_max(mloc);
  if (t == 0 && g < G) wmax[warp * G + g] = mloc;
  const float m = cluster_max<G>(wmax, bmax, splits);  // head g's pair max

  float l = 0.f;  // head g's sum of p over the lane's columns
  float oacc[KC][4];  // bf16 forms: both tiers; integer dots: the ring
  int iacc[F::INT ? KC : 1][4];  // integer dots: the main tier
#pragma unroll
  for (int i = 0; i < KC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < (F::INT ? KC : 1); ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) iacc[i][e] = 0;
  cp_async_wait<0>();
  __syncwarp();  // the vs of the run have landed in every lane

  // ---- the residual ring first: bf16(p) into P^T, rows into V^T -------------
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
    float sv[2][2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float2 v = make_float2(-INFINITY, -INFINITY);
      if (g < G)
        v = *reinterpret_cast<const float2*>(res_sc + (i * G + g) * STEP + 8 * x + 2 * t);
      sv[x][0] = v.x;
      sv[x][1] = v.y;
    }
    const float one[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
    uint32_t pb[2];
    p_frags<true>(sv, m, l, pb, one);
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

  // ---- integer dots: p * vs in place of the scores, and ps ------------------
  float ps = 0.f;
  if constexpr (F::INT) {
    float pmax = 0.f;
    for (int j = 0; j < nmain; ++j)
#pragma unroll
      for (int x = 0; x < NT; ++x) {
        float* sp = main_sc + (j * G + g) * ST + 8 * x + 2 * t;
        float2 v = make_float2(-INFINITY, -INFINITY);
        if (g < G) v = *reinterpret_cast<const float2*>(sp);
        float sv[2] = {v.x, v.y}, pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int idx, row, tok;
          main_at(j, x, 2 * t + e, idx, row, tok);
          const float p = sv[e] == -INFINITY ? 0.f : expf(sv[e] - m);
          l += p;
          pv[e] = __fmul_rn(p, sbuf[idx]);
          pmax = fmaxf(pmax, pv[e]);
        }
        if (g < G) *reinterpret_cast<float2*>(sp) = make_float2(pv[0], pv[1]);
      }
    pmax = quad_max(pmax);
    if (t == 0 && g < G) wmax2[warp * G + g] = pmax;
    float pm = cluster_max<G>(wmax2, bmax2, splits);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      pm = fmaxf(pm, __shfl_xor_sync(0xffffffffu, pm, o));
    ps = __fdiv_rn(fmaxf(pm, 1e-30f), 127.f);
  }

  // ---- the main tier through the ring ---------------------------------------
  const int sh_v = 4 * t;  // I4: planes t and t + 4 of a word
  const float rps = __frcp_rn(ps);
  for (int k = 0; k < nst; ++k) {
    // the P^T fragments of the stage's steps, from this lane's own scores,
    // before the wait for its V: integer dots p8 = rint(p * vs / ps), bytes
    // k = 4t + (0..3) of tiles 0-1 (b0) and 2-3 (b1), columns 2t and 2t + 1;
    // bf16 dots bf16(p * vs) of each k16 chunk h (tiles 2h, 2h + 1)
    uint32_t pbs[F::SPS][F::INT ? 2 : NT][2];
#pragma unroll
    for (int s = 0; s < F::SPS; ++s) {
      const int j = k * F::SPS + s;
      if (j >= nmain) break;  // warp-uniform
      if constexpr (F::INT) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w = 0u;
#pragma unroll
          for (int xx = 0; xx < 2; ++xx) {
            float2 v = make_float2(0.f, 0.f);
            if (g < G)
              v = *reinterpret_cast<const float2*>(
                  main_sc + (j * G + g) * ST + 8 * (2 * h + xx) + 2 * t);
            const uint32_t c0 = static_cast<uint32_t>(rintf(div_by(v.x, ps, rps)));
            const uint32_t c1 = static_cast<uint32_t>(rintf(div_by(v.y, ps, rps)));
            w |= (c0 | (c1 << 8)) << (16 * xx);
          }
          pbs[s][h][0] = w;
        }
      } else {
#pragma unroll
        for (int h = 0; h < NT / 2; ++h) {
          float sv[2][2], wv[2][2];
#pragma unroll
          for (int xx = 0; xx < 2; ++xx) {
            const int x = 2 * h + xx;
            float2 v = make_float2(-INFINITY, -INFINITY);
            if (g < G)
              v = *reinterpret_cast<const float2*>(main_sc + (j * G + g) * ST + 8 * x + 2 * t);
            sv[xx][0] = v.x;
            sv[xx][1] = v.y;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int idx, row, tok;
              main_at(j, x, 2 * t + e, idx, row, tok);
              wv[xx][e] = sbuf[idx];
            }
          }
          p_frags<true>(sv, m, l, pbs[s][h], wv);
        }
      }
    }
    wait(nst + k);
    const uint8_t* st = ring + ((nst + k) % F::STAGES) * F::STAGE;
#pragma unroll
    for (int s = 0; s < F::SPS; ++s) {
      const int j = k * F::SPS + s;
      if (j >= nmain) break;  // warp-uniform
      if constexpr (F::INT) {
        const uint32_t pb8[2] = {pbs[s][0][0], pbs[s][1][0]};
        // V rows of k = 4t + r: tokens of tiles 0-1 (group 0) and 2-3
        // (group 1), columns 2t, 2t + 1
        uint32_t vb[2][4][FL / 4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = s * ST + step_tok<FORM>(2 * h + (r >> 1), 2 * t + (r & 1));
            const uint8_t* vp = st + row * D + FL * g;
            if constexpr (FL == 16) {
              const uint4 v4 = lds128(vp);
              vb[h][r][0] = v4.x; vb[h][r][1] = v4.y;
              vb[h][r][2] = v4.z; vb[h][r][3] = v4.w;
            } else {
              const uint2 v2 = *reinterpret_cast<const uint2*>(vp);
              vb[h][r][0] = v2.x; vb[h][r][1] = v2.y;
            }
          }
#pragma unroll
        for (int qq = 0; qq < FL / 4; ++qq) {
          uint32_t oa[4], ob[4];
          const uint32_t wa[4] = {vb[0][0][qq], vb[0][1][qq], vb[0][2][qq], vb[0][3][qq]};
          const uint32_t wb[4] = {vb[1][0][qq], vb[1][1][qq], vb[1][2][qq], vb[1][3][qq]};
          transpose4(wa, oa);  // oa[i]: feature FL g + 4qq + i, k 4t..4t+3
          transpose4(wb, ob);
#pragma unroll
          for (int s2 = 0; s2 < 2; ++s2)
            mma_s8(iacc[2 * qq + s2], oa[2 * s2], oa[2 * s2 + 1], ob[2 * s2],
                   ob[2 * s2 + 1], pb8[0], pb8[1]);
        }
      } else {
        const auto& pb = pbs[s];
        if constexpr (FORM == I4) {
          uint32_t vw[2][FL];  // lane g's FL words of the step's two rows
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int q4 = 0; q4 < FL / 4; ++q4) {
              const uint4 v4 = lds128(st + (2 * s + x) * F::ROWB + 4 * (FL * g + 4 * q4));
              vw[x][4 * q4] = v4.x;
              vw[x][4 * q4 + 1] = v4.y;
              vw[x][4 * q4 + 2] = v4.z;
              vw[x][4 * q4 + 3] = v4.w;
            }
#pragma unroll
          for (int i2 = 0; i2 < KC; ++i2)
            mma_bf16(oacc[i2], deq4(vw[0][2 * i2] >> sh_v, mask, magic),
                     deq4(vw[0][2 * i2 + 1] >> sh_v, mask, magic),
                     deq4(vw[1][2 * i2] >> sh_v, mask, magic),
                     deq4(vw[1][2 * i2 + 1] >> sh_v, mask, magic), pb[0][0],
                     pb[0][1]);
        } else {
          // rows of tile x, columns 2t + e; their bytes XORed with 0x80
          uint32_t vb[NT][2][FL / 4];
#pragma unroll
          for (int x = 0; x < NT; ++x)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint8_t* vp = st + (s * ST + step_tok<FORM>(x, 2 * t + e)) * D + FL * g;
              if constexpr (FL == 16) {
                const uint4 v4 = lds128(vp);
                vb[x][e][0] = v4.x ^ 0x80808080u; vb[x][e][1] = v4.y ^ 0x80808080u;
                vb[x][e][2] = v4.z ^ 0x80808080u; vb[x][e][3] = v4.w ^ 0x80808080u;
              } else {
                const uint2 v2 = *reinterpret_cast<const uint2*>(vp);
                vb[x][e][0] = v2.x ^ 0x80808080u; vb[x][e][1] = v2.y ^ 0x80808080u;
              }
            }
#pragma unroll
          for (int h = 0; h < NT / 2; ++h)
#pragma unroll
            for (int i2 = 0; i2 < KC; ++i2) {
              const int qq = i2 >> 1;
              uint32_t a0, a1, a2, a3;
              if (i2 & 1) {
                a0 = bf16_pair2<2>(vb[2 * h][0][qq], vb[2 * h][1][qq]);
                a1 = bf16_pair2<3>(vb[2 * h][0][qq], vb[2 * h][1][qq]);
                a2 = bf16_pair2<2>(vb[2 * h + 1][0][qq], vb[2 * h + 1][1][qq]);
                a3 = bf16_pair2<3>(vb[2 * h + 1][0][qq], vb[2 * h + 1][1][qq]);
              } else {
                a0 = bf16_pair2<0>(vb[2 * h][0][qq], vb[2 * h][1][qq]);
                a1 = bf16_pair2<1>(vb[2 * h][0][qq], vb[2 * h][1][qq]);
                a2 = bf16_pair2<0>(vb[2 * h + 1][0][qq], vb[2 * h + 1][1][qq]);
                a3 = bf16_pair2<1>(vb[2 * h + 1][0][qq], vb[2 * h + 1][1][qq]);
              }
              mma_bf16(oacc[i2], a0, a1, a2, a3, pb[h][0], pb[h][1]);
            }
        }
      }
    }
    __syncwarp();
    fence_proxy_async();
    if (k + F::STAGES < nst) issue(nst + k + F::STAGES, k + F::STAGES, true);
  }

  // ---- the warps' partials, then the merge ---------------------------------
  const float lh = quad_sum(l);
  __syncthreads();  // every ring is free
  float* warps = reinterpret_cast<float*>(smem);
  float* wp = warps + warp * G * F::REC;
  if (t == 0 && g < G) wp[g * F::REC] = lh;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int h = 2 * t + x;
    if (h < G) {
      float* r = wp + h * F::REC + 1;
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        r[FL * g + 2 * i] = oacc[i][x];
        r[FL * g + 2 * i + 1] = oacc[i][2 + x];
        if constexpr (F::INT) {
          r[D + FL * g + 2 * i] = __int_as_float(iacc[i][x]);
          r[D + FL * g + 2 * i + 1] = __int_as_float(iacc[i][2 + x]);
        }
      }
    }
  }
  cluster_finish<G, D, F::INT ? EXTRA_INT : EXTRA_NONE>(
      warps, warps + WARPS * G * F::REC, F::REC, 1, ps, splits,
      a.out + (static_cast<size_t>(b) * H + kvh * G) * D);
}

// Calls f(form) as a std::integral_constant for a form in [0, 5).
template <typename Fn>
bool with_form(int form, Fn&& f) {
  switch (form) {
    case I4: f(std::integral_constant<int, I4>{}); return true;
    case I8: f(std::integral_constant<int, I8>{}); return true;
    case I8KT: f(std::integral_constant<int, I8KT>{}); return true;
    case ID: f(std::integral_constant<int, ID>{}); return true;
    case IDKT: f(std::integral_constant<int, IDKT>{}); return true;
    default: return false;
  }
}

// The launch's shared memory (as ops/int_kv_attention.py:int_kv_decode_smem
// computes it), from a 1024-byte line (the K^T rings' swizzle): the rings,
// or the warps' and the block's partials, whichever is larger; the ring
// barriers; each warp's run of scales and its scores; the maxima.
template <int FORM, int D>
void layout(Args& a, int G, int splits) {
  using F = Geo<FORM, D>;
  const int W = WARPS * splits;
  a.max_main = cdiv(cdiv(a.P / F::PER, F::SR), W);
  a.max_res = cdiv(cdiv(a.R, STEP), W);
  const int ring = WARPS * F::STAGES * F::STAGE;
  const int parts = (WARPS + 1) * G * F::REC * 4;
  a.bar0 = ((ring > parts ? ring : parts) + 15) / 16 * 16;
  a.sbuf0 = a.bar0 + WARPS * F::STAGES * 8;
  a.scores0 = a.sbuf0 + WARPS * a.max_main * F::ST * 4;
  a.max0 = a.scores0 + WARPS * (a.max_main * F::ST + a.max_res * STEP) * G * 4;
  a.smem = a.max0 + (2 * WARPS * G + 2 * G) * 4 + 1024;  // + the alignment
}

template <int FORM, int D, int G>
int launch(const Args& a, int B, int splits, cudaStream_t st) {
  if (a.smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t cap = allow_smem<int_kv_mma<FORM, D, G>>();
  if (cap != cudaSuccess) return static_cast<int>(cap);
  // K^T: the (B * KV * D, P) byte matrix in boxes of a stage's 64 tokens
  // by the D feature rows of a (batch, kv head), in the 64-byte swizzle
  CUtensorMap kt_map = {};
  if (Geo<FORM, D>::KT) {
    const cudaError_t err = tensor_map(
        &kt_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.kc, a.P, B * a.KV * D, 1,
        Geo<FORM, D>::KROW, D, CU_TENSOR_MAP_SWIZZLE_64B);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.KV, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, int_kv_mma<FORM, D, G>, a, kt_map);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The argument checks and the layout shared by int_kv_decode and
// int_kv_decode_smem; false where the kernel does not take the call.
bool make_args(Args& a, int B, int H, int KV, int D, int P, int R, int form,
               int splits) {
  const bool kt = form == I8KT || form == IDKT;
  if (KV <= 0 || B <= 0 || H % KV || P <= 0 || R < 0 || P % (kt ? 16 : 8) ||
      splits < 1 || splits > MAX_SPLITS)
    return false;
  a.KV = KV;
  a.P = P;
  a.R = R;
  a.mask = 0x000f000fu;
  a.magic = 0x43084308u;
  bool taken = false;
  with_dg(D, H / KV, [&](auto d, auto) {
    constexpr int DD = decltype(d)::value;
    taken = with_form(form, [&](auto f) {
      layout<decltype(f)::value, DD>(a, H / KV, splits);
    });
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
long long int_kv_decode_smem(int B, int H, int KV, int D, int P, int R,
                             int form, int splits) {
  Args a = {};
  if (!make_args(a, B, H, KV, D, P, R, form, splits)) return 0;
  return a.smem;
}

// Blocks of the kernel for (form, D, G) that one SM holds at `smem` bytes
// of shared memory a block (0 where the kernel is not instantiated): what
// int_kv_decode_plan needs to keep the grid in one wave.
int int_kv_decode_blocks_per_sm(int form, int D, int G, long long smem) {
  int n = 0;
  with_dg(D, G, [&](auto d, auto g) {
    constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
    with_form(form, [&](auto f) {
      constexpr auto kernel = int_kv_mma<decltype(f)::value, DD, GG>;
      allow_smem<kernel>();
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                    static_cast<size_t>(smem));
    });
  });
  return n;
}

// Every pointer 16-byte aligned.  D in {64, 128}, G = H / KV in {1, 2, 4,
// 8}; form 0 (int4 words, bf16 dots), 1 (int8, bf16 dots), 2 (int8 K^T,
// bf16 dots), 3 (int8, integer dots), 4 (int8 K^T, integer dots); P % 8
// == 0, and P % 16 == 0 for the K^T forms (the tensor map's row stride).  `splits` (1-8 blocks a (batch,
// kv head) pair, one cluster) is int_kv_decode_plan's
// (ops/int_kv_attention.py); a block's shared memory (int_kv_decode_smem)
// must fit in 227 KB.
int int_kv_decode(const void* q, const void* k_codes, const void* k_scale,
                  const void* v_codes, const void* v_scale, const void* k_res,
                  const void* v_res, const void* main_len, const void* res_len,
                  void* out, int B, int H, int KV, int D, int P, int R,
                  int form, float scale, int splits, void* stream) {
  Args a = {};
  if (!make_args(a, B, H, KV, D, P, R, form, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = static_cast<const uint16_t*>(q);
  a.kc = static_cast<const uint8_t*>(k_codes);
  a.ks = static_cast<const float*>(k_scale);
  a.vc = static_cast<const uint8_t*>(v_codes);
  a.vs = static_cast<const float*>(v_scale);
  a.kr = static_cast<const uint16_t*>(k_res);
  a.vr = static_cast<const uint16_t*>(v_res);
  a.main_len = static_cast<const int32_t*>(main_len);
  a.res_len = static_cast<const int32_t*>(res_len);
  a.out = static_cast<uint16_t*>(out);
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  with_dg(D, H / KV, [&](auto d, auto g) {
    constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
    with_form(form, [&](auto f) {
      err = launch<decltype(f)::value, DD, GG>(a, B, splits, st);
    });
  });
  return err;
}

}  // extern "C"
