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
// (_kernel, reached through int_kv_decode_attention) in all its forms:
// bits 4 or 8 with bf16 dots over untransposed K (int_kv_split + merge,
// below), and the integer-dot and K^T forms at bits 8 (int_kv_tile).  Each
// kernel is instantiated for G = H / KV in {1, 2, 4, 8} query heads per kv
// head and D in {64, 128}; query head h reads kv head h / G (the reference's
// q.reshape(B, KV, G, D), and csrc/flash_attn_fwd.cu's kvh = h / (H / KV)).
//
// What bounds it on an H100: the bytes of the codes, scales and residual
// ring over 3.35 TB/s, read once per kv head whatever G is.  At 8 full
// slots (P = 2048, R = 128) of one layer: LLaMA-2 7B (KV = 32) about 88 MB
// with int4 codes, 155 MB with int8; Phi-3-medium (KV = 10, G = 4) with
// int4 codes 21.0 MB of codes, 1.3 MB of scales and 5.2 MB of ring, about
// 27.5 MB or 8.2 us.
//
// The bf16-dot forms over untransposed K: the TPU grid is one program per
// (batch, kv head) -- 256 at the 7B decode shape, too few to keep 132 SMs'
// memory pipes busy -- so int_kv_split splits the tokens (flash-decoding):
// each block takes 256 tokens of the main tier (32 int4 word rows, or 256
// int8 rows), or 256 rows of the residual ring, for one (batch, kv head)
// and all G query heads of it, as the TPU step reads one (G, D) q tile
// against one cache tile: each K/V row is read once and dotted with G
// queries.  It keeps its G rows of scores in shared memory and writes a
// partial (max, sum, f32 accumulator) per query head; a second small
// kernel merges the partials.  Word
// rows holding no token below main_len are never read (plane 0 holds the
// lowest token of a word row), so a short prompt costs only its own bytes.
// Each warp reads whole word rows (lane j holds d = DL*j .. DL*j + DL - 1,
// DL = D / 32) and sign-extends a field with a left shift of the unsigned
// word and an arithmetic right shift of its int32 reinterpretation.
//
// The integer-dot and K^T forms (int_kv_tile): the reference quantizes q
// against one scale over the whole (G, D) tile, and p * vs against one
// scale over the whole (G, P) tile after the global softmax max, so a token
// split would round against its own max and give other int8 codes.  So one
// block takes one (batch, kv head), as the TPU grid does, with all G * P
// scores in dynamic shared memory (4 bytes a token and head: 135 KB at
// G = 8, P = 4096, R = 128; a shape whose scores and static arrays exceed
// the card's 227 KB per block is refused, see int_kv_tile_smem): both
// scales are block-wide reductions over the G heads.  It rounds where the
// reference rounds, and both integer dots are exact, so its codes equal
// the plain version's but where an exp differs by an ulp at a rounding
// boundary.  B * KV blocks of 256 threads.  Scores: over K^T each thread
// takes 8 consecutive tokens and walks the D rows (8-byte loads, coalesced
// across threads); over untransposed K, D / 16 lanes share a row (16 bytes
// each) and sum with __dp4a.  Values: D / 16 lanes per V row, 16 codes a
// lane, 512 / D rows per warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SPLIT_TOKENS = 256;            // tokens per block, both tiers
constexpr float NEG_INF = -1073741824.0f;    // -2^30

// codes per row and main-tier rows per block: int4 words hold 8 tokens
template <int BITS> struct Tier {
  static constexpr int PER = BITS == 4 ? 8 : 1;
  static constexpr int ROWS = SPLIT_TOKENS / PER;
};

__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// code of plane s: a 4-bit field of an int32 word, or an int8 code
template <int BITS>
__device__ __forceinline__ int code_of(uint32_t word, int s) {
  if (BITS == 8) return static_cast<int8_t>(word & 0xffu);
  return static_cast<int32_t>(word << (28 - 4 * s)) >> 28;
}

// the DL codes (or words) of one lane in main-tier row t
template <int BITS, int DL>
__device__ __forceinline__ void load_row(const void* base, size_t row, int D,
                                         int lane, int32_t* wv) {
  if (BITS == 8) {
    const int8_t* p = static_cast<const int8_t*>(base) + row * D + DL * lane;
#pragma unroll
    for (int j = 0; j < DL; ++j) wv[j] = p[j];
  } else {
    const int32_t* p = static_cast<const int32_t*>(base) + row * D + DL * lane;
#pragma unroll
    for (int j = 0; j < DL; ++j) wv[j] = p[j];
  }
}

// block-wide max and sum over NW warps (red holds NW floats); every
// thread gets the result
template <int NW = NWARPS>
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) r = fmaxf(r, red[w]);
  return r;
}

template <int NW = NWARPS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) r += red[w];
  return r;
}

// G: query heads per kv head; D: head dim (DL = D/32 values per lane).
// Static shared memory: qsh, sc, red and accsh, 4 bytes each: 28.0 KB at
// G = 8, D = 128 (under the 48 KB a static array may take).
template <int D, int G, int BITS>
__global__ void __launch_bounds__(NTHREADS)
int_kv_split(const uint16_t* __restrict__ q, const void* __restrict__ kc,
             const float* __restrict__ ks, const void* __restrict__ vc,
             const float* __restrict__ vsc, const uint16_t* __restrict__ kr,
             const uint16_t* __restrict__ vr, const int32_t* __restrict__ main_len,
             const int32_t* __restrict__ res_len, float* __restrict__ m_part,
             float* __restrict__ l_part, float* __restrict__ acc_part, int KV,
             int P, int R, float scale, int n_main) {
  constexpr int DL = D / 32;
  constexpr int PER = Tier<BITS>::PER;
  constexpr int SPLIT_WORDS = Tier<BITS>::ROWS;
  static_assert(D % 32 == 0, "a warp covers a row");
  static_assert(4 * (G * D + G * SPLIT_TOKENS + NWARPS + NWARPS * G * D) <= 48 * 1024,
                "static shared memory");
  __shared__ float qsh[G][D];
  __shared__ float sc[G][SPLIT_TOKENS];
  __shared__ float red[NWARPS];
  __shared__ float accsh[NWARPS][G][D];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = KV * G;
  const int NS = gridDim.x;
  const int Pw = P / PER;
  const int ml = min(max(main_len[b], 0), P);
  const int rl = min(max(res_len[b], 0), R);
  const size_t bk = static_cast<size_t>(b) * KV + kvh;

  const bool is_main = split < n_main;
  // main: word rows [w0, w1) hold a valid token only below ml
  const int w0 = split * SPLIT_WORDS;
  const int w1 = min(min(w0 + SPLIT_WORDS, Pw), ml);
  // residual: rows [r0, r1)
  const int r0 = (split - n_main) * SPLIT_TOKENS;
  const int r1 = min(r0 + SPLIT_TOKENS, rl);
  const bool empty = is_main ? (w0 >= w1) : (r0 >= r1);

  if (empty) {  // block-uniform
    for (int idx = tid; idx < G * D; idx += NTHREADS) {
      const int g = idx / D, d = idx % D;
      const size_t hs = (static_cast<size_t>(b) * H + kvh * G + g) * NS + split;
      acc_part[hs * D + d] = 0.f;
      if (d == 0) {
        m_part[hs] = NEG_INF;
        l_part[hs] = 0.f;
      }
    }
    return;
  }

  for (int idx = tid; idx < G * D; idx += NTHREADS) {
    const int g = idx / D, d = idx % D;
    const float qv = bf16_to_float(q[(static_cast<size_t>(b) * H + kvh * G + g) * D + d]);
    qsh[g][d] = round_bf16(qv * scale);
  }
  for (int idx = tid; idx < G * SPLIT_TOKENS; idx += NTHREADS)
    sc[idx / SPLIT_TOKENS][idx % SPLIT_TOKENS] = NEG_INF;
  __syncthreads();

  float qreg[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DL; ++j) qreg[g][j] = qsh[g][DL * lane + j];

  // ---- scores ------------------------------------------------------------
  if (is_main) {
    const float* ksp = ks + bk * P;
    for (int t = w0 + warp; t < w1; t += NWARPS) {
      int32_t wv[DL];
      load_row<BITS, DL>(kc, bk * Pw + t, D, lane, wv);
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        const int tok = s * Pw + t;
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < DL; ++j)
            a += qreg[g][j] * static_cast<float>(code_of<BITS>(static_cast<uint32_t>(wv[j]), s));
          part[g] = warp_sum(a);
        }
        if (lane == 0 && tok < ml) {
          const float kscale = ksp[tok];
#pragma unroll
          for (int g = 0; g < G; ++g) sc[g][s * SPLIT_WORDS + (t - w0)] = part[g] * kscale;
        }
      }
    }
  } else {
    const uint16_t* krp = kr + bk * R * D;
    for (int r = r0 + warp; r < r1; r += NWARPS) {
      float kv[DL];
#pragma unroll
      for (int j = 0; j < DL; ++j) kv[j] = bf16_to_float(krp[static_cast<size_t>(r) * D + DL * lane + j]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < DL; ++j) a += qreg[g][j] * kv[j];
        a = warp_sum(a);
        if (lane == 0) sc[g][r - r0] = a;
      }
    }
  }
  __syncthreads();

  // ---- softmax statistics of this split; p (times vs) rounded to bf16 ----
  const float* vsp = vsc + bk * P;
  float m_g[G], l_g[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = NEG_INF;
    for (int i = tid; i < SPLIT_TOKENS; i += NTHREADS) mx = fmaxf(mx, sc[g][i]);
    m_g[g] = block_max(mx, red);
    float sum = 0.f;
    for (int i = tid; i < SPLIT_TOKENS; i += NTHREADS) {
      const float sv = sc[g][i];
      float p = 0.f;
      float pv = 0.f;
      if (sv != NEG_INF) {
        p = expf(sv - m_g[g]);
        if (is_main) {
          const int tok = (i / SPLIT_WORDS) * Pw + w0 + (i % SPLIT_WORDS);
          pv = round_bf16(p * vsp[tok]);
        } else {
          pv = round_bf16(p);
        }
      }
      sum += p;
      sc[g][i] = pv;  // each thread rewrites only entries it read
    }
    l_g[g] = block_sum(sum, red);
  }
  __syncthreads();

  // ---- weighted values ---------------------------------------------------
  float acc[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[g][j] = 0.f;
  if (is_main) {
    for (int t = w0 + warp; t < w1; t += NWARPS) {
      int32_t wv[DL];
      load_row<BITS, DL>(vc, bk * Pw + t, D, lane, wv);
#pragma unroll
      for (int s = 0; s < PER; ++s) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pv = sc[g][s * SPLIT_WORDS + (t - w0)];
#pragma unroll
          for (int j = 0; j < DL; ++j)
            acc[g][j] += pv * static_cast<float>(code_of<BITS>(static_cast<uint32_t>(wv[j]), s));
        }
      }
    }
  } else {
    const uint16_t* vrp = vr + bk * R * D;
    for (int r = r0 + warp; r < r1; r += NWARPS) {
      float vv[DL];
#pragma unroll
      for (int j = 0; j < DL; ++j) vv[j] = bf16_to_float(vrp[static_cast<size_t>(r) * D + DL * lane + j]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sc[g][r - r0];
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[g][j] += p * vv[j];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DL; ++j) accsh[warp][g][DL * lane + j] = acc[g][j];
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += NTHREADS) {
    const int g = idx / D, d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) a += accsh[w][g][d];
    const size_t hs = (static_cast<size_t>(b) * H + kvh * G + g) * NS + split;
    acc_part[hs * D + d] = a;
    if (d == 0) {
      m_part[hs] = m_g[g];
      l_part[hs] = l_g[g];
    }
  }
}

// one block of D threads per (batch, head): out = sum_s w_s acc_s / sum_s w_s l_s
__global__ void int_kv_merge(const float* __restrict__ m_part,
                             const float* __restrict__ l_part,
                             const float* __restrict__ acc_part,
                             uint16_t* __restrict__ out, int NS, int D) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* mp = m_part + bh * NS;
  const float* lp = l_part + bh * NS;
  float mx = NEG_INF;
  for (int s = 0; s < NS; ++s)
    if (lp[s] > 0.f) mx = fmaxf(mx, mp[s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < NS; ++s) {
    if (lp[s] > 0.f) {
      const float w = expf(mp[s] - mx);
      l += w * lp[s];
      a += w * acc_part[(bh * NS + s) * D + d];
    }
  }
  const float val = round_bf16(a / (l == 0.f ? 1.f : l));
  out[bh * D + d] = static_cast<uint16_t>(__float_as_uint(val) >> 16);
}

// ---- the integer-dot and K^T forms: one block per (batch, kv head) ----
constexpr int TILE_WARPS = 8;
constexpr int TILE_THREADS = TILE_WARPS * 32;

__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return static_cast<int>(w << (24 - 8 * j)) >> 24;
}

// Static shared memory of int_kv_tile<D, G>: qb, q8, red and accw.
template <int D, int G>
__host__ __device__ constexpr int tile_static_bytes() {
  return 4 * G * D + G * D + 4 * TILE_WARPS + 4 * TILE_WARPS * G * D;
}

// G: query heads per kv head; D: head dim.  Dynamic shared memory holds the
// G*P main scores and the G*R residual scores (f32).  A row of D int8 codes
// is LPR = D/16 lanes of 16 bytes; a warp covers RPW = 32/LPR rows.  accw
// holds each warp's partial sums, first of the main tier, then of the ring
// (37.0 KB static at G = 8, D = 128).
template <int D, int G, bool INT_DOTS, bool KT>
__global__ void __launch_bounds__(TILE_THREADS)
int_kv_tile(const uint16_t* __restrict__ q, const int8_t* __restrict__ kc,
            const float* __restrict__ ks, const int8_t* __restrict__ vc,
            const float* __restrict__ vsc, const uint16_t* __restrict__ kr,
            const uint16_t* __restrict__ vr, const int32_t* __restrict__ main_len,
            const int32_t* __restrict__ res_len, uint16_t* __restrict__ out,
            int KV, int P, int R, float scale) {
  static_assert(D == 64 || D == 128, "D/16 lanes of 16 bytes cover a row");
  static_assert(tile_static_bytes<D, G>() <= 48 * 1024, "static shared memory");
  constexpr int DL = D / 32;
  constexpr int LPR = D / 16;                 // lanes per row
  constexpr int RPW = 32 / LPR;               // rows per warp
  constexpr int OPT = (G * D + TILE_THREADS - 1) / TILE_THREADS;  // outputs a thread
  extern __shared__ float dyn[];
  float* sc = dyn;           // [G][P]: scores, then p * vs (bf16) or p8
  float* scr = dyn + G * P;  // [G][R]: residual scores, then bf16(p)
  __shared__ float qb[G][D];
  __shared__ __align__(16) int8_t q8[G][D];
  __shared__ float red[TILE_WARPS];
  __shared__ float accw[TILE_WARPS][G][D];    // int sums as their bits

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % LPR;  // a lane's 16 codes of a row
  const int rsub = lane / LPR; // a warp's RPW rows
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int ml = min(max(main_len[b], 0), P);
  const int rl = min(max(res_len[b], 0), R);
  const size_t bk = static_cast<size_t>(b) * KV + kvh;

  // ---- q: q * scale, its bf16 rounding and (integer dots) its int8 codes,
  // one scale over the whole (G, D) tile: query head kvh*G + g is row g
  float qmax = 0.f;
  float qfv[OPT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int idx = tid + k * TILE_THREADS;
    qfv[k] = 0.f;
    if (idx < G * D) {
      const float v = __fmul_rn(bf16_to_float(q[bk * G * D + idx]), scale);
      qfv[k] = v;
      qb[idx / D][idx % D] = round_bf16(v);
      qmax = fmaxf(qmax, fabsf(v));
    }
  }
  float qs = 0.f;
  if (INT_DOTS) {
    qs = __fdiv_rn(fmaxf(block_max<TILE_WARPS>(qmax, red), 1e-30f), 127.f);
#pragma unroll
    for (int k = 0; k < OPT; ++k) {
      const int idx = tid + k * TILE_THREADS;
      if (idx < G * D)
        q8[idx / D][idx % D] = static_cast<int8_t>(
            static_cast<int>(rintf(__fdiv_rn(qfv[k], qs))));
    }
  }
  __syncthreads();

  // ---- main scores -----------------------------------------------------
  const float* ksp = ks + bk * P;
  if (KT) {
    const int8_t* kb = kc + bk * static_cast<size_t>(D) * P;  // (D, P)
    for (int c = tid; 8 * c < ml; c += TILE_THREADS) {
      const int t0 = 8 * c;
      int ai[G][8];
      float af[G][8];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) ai[g][j] = 0, af[g][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const uint2 w = *reinterpret_cast<const uint2*>(kb + static_cast<size_t>(d) * P + t0);
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int code = sbyte(j < 4 ? w.x : w.y, j & 3);
            if (INT_DOTS) ai[g][j] += static_cast<int>(q8[g][d]) * code;
            else af[g][j] = __fadd_rn(af[g][j], __fmul_rn(qb[g][d], static_cast<float>(code)));
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int t = t0 + j;
          if (t < ml)
            sc[g * P + t] = INT_DOTS
                ? __fmul_rn(static_cast<float>(ai[g][j]), __fmul_rn(ksp[t], qs))
                : __fmul_rn(af[g][j], ksp[t]);
        }
    }
  } else {  // untransposed K, integer dots: LPR lanes per row, __dp4a
    const int8_t* kb = kc + bk * static_cast<size_t>(P) * D;  // (P, D)
    int qw[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) qw[g][j] = reinterpret_cast<const int*>(q8[g])[4 * sub + j];
    for (int t0 = RPW * warp; t0 < ml; t0 += RPW * TILE_WARPS) {
      const int t = t0 + rsub;
      int4 w = make_int4(0, 0, 0, 0);
      if (t < ml) w = *reinterpret_cast<const int4*>(kb + static_cast<size_t>(t) * D + 16 * sub);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        int a = __dp4a(w.x, qw[g][0], 0);
        a = __dp4a(w.y, qw[g][1], a);
        a = __dp4a(w.z, qw[g][2], a);
        a = __dp4a(w.w, qw[g][3], a);
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (sub == 0 && t < ml)
          sc[g * P + t] = __fmul_rn(static_cast<float>(a), __fmul_rn(ksp[t], qs));
      }
    }
  }

  // ---- residual scores (bf16 dots) ---------------------------------------
  const uint16_t* krp = kr + bk * R * D;
  for (int r = warp; r < rl; r += TILE_WARPS) {
    float kv[DL];
#pragma unroll
    for (int j = 0; j < DL; ++j) kv[j] = bf16_to_float(krp[static_cast<size_t>(r) * D + DL * lane + j]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < DL; ++j) a += qb[g][DL * lane + j] * kv[j];
      a = warp_sum(a);
      if (lane == 0) scr[g * R + r] = a;
    }
  }
  __syncthreads();

  // ---- one softmax over [main; residual] per query row; pmax over all G ----
  const float* vsp = vsc + bk * P;
  float l_g[G];
  float pmax = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = NEG_INF;
    for (int t = tid; t < ml; t += TILE_THREADS) mx = fmaxf(mx, sc[g * P + t]);
    for (int r = tid; r < rl; r += TILE_THREADS) mx = fmaxf(mx, scr[g * R + r]);
    const float m = block_max<TILE_WARPS>(mx, red);
    float sum_m = 0.f, sum_r = 0.f;
    for (int t = tid; t < ml; t += TILE_THREADS) {
      const float p = expf(__fsub_rn(sc[g * P + t], m));
      sum_m += p;
      const float pv = __fmul_rn(p, vsp[t]);
      pmax = fmaxf(pmax, fabsf(pv));
      sc[g * P + t] = INT_DOTS ? pv : round_bf16(pv);
    }
    for (int r = tid; r < rl; r += TILE_THREADS) {
      const float p = expf(__fsub_rn(scr[g * R + r], m));
      sum_r += p;
      scr[g * R + r] = round_bf16(p);
    }
    const float lm = block_sum<TILE_WARPS>(sum_m, red);
    l_g[g] = __fadd_rn(lm, block_sum<TILE_WARPS>(sum_r, red));
  }
  float ps = 0.f;
  if (INT_DOTS) {
    ps = __fdiv_rn(fmaxf(block_max<TILE_WARPS>(pmax, red), 1e-30f), 127.f);
#pragma unroll
    for (int g = 0; g < G; ++g)
      for (int t = tid; t < ml; t += TILE_THREADS)
        sc[g * P + t] = rintf(__fdiv_rn(sc[g * P + t], ps));
  }
  __syncthreads();

  // ---- weighted values: main tier, LPR lanes per row ---------------------
  const int8_t* vb = vc + bk * static_cast<size_t>(P) * D;
  int vi[G][16];
  float vf[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 16; ++j) vi[g][j] = 0, vf[g][j] = 0.f;
  for (int t = RPW * warp + rsub; t < ml; t += RPW * TILE_WARPS) {
    const int4 w = *reinterpret_cast<const int4*>(vb + static_cast<size_t>(t) * D + 16 * sub);
    const uint32_t wv[4] = {static_cast<uint32_t>(w.x), static_cast<uint32_t>(w.y),
                            static_cast<uint32_t>(w.z), static_cast<uint32_t>(w.w)};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pc = sc[g * P + t];
      const int pi = static_cast<int>(pc);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int code = sbyte(wv[j >> 2], j & 3);
        if (INT_DOTS) vi[g][j] += pi * code;
        else vf[g][j] = __fadd_rn(vf[g][j], __fmul_rn(pc, static_cast<float>(code)));
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (INT_DOTS) {
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) vi[g][j] += __shfl_xor_sync(0xffffffffu, vi[g][j], o);
        if (rsub == 0) accw[warp][g][16 * sub + j] = __int_as_float(vi[g][j]);
      } else {
#pragma unroll
        for (int o = LPR; o < 32; o <<= 1) vf[g][j] += __shfl_xor_sync(0xffffffffu, vf[g][j], o);
        if (rsub == 0) accw[warp][g][16 * sub + j] = vf[g][j];
      }
    }
  __syncthreads();
  float main_o[OPT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int idx = tid + k * TILE_THREADS;
    main_o[k] = 0.f;
    if (idx < G * D) {
      const int g = idx / D, d = idx % D;
      if (INT_DOTS) {
        int a = 0;
#pragma unroll
        for (int w = 0; w < TILE_WARPS; ++w) a += __float_as_int(accw[w][g][d]);
        main_o[k] = __fmul_rn(static_cast<float>(a), ps);
      } else {
#pragma unroll
        for (int w = 0; w < TILE_WARPS; ++w) main_o[k] += accw[w][g][d];
      }
    }
  }
  __syncthreads();

  // ---- weighted values: residual ring -------------------------------------
  float ar[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DL; ++j) ar[g][j] = 0.f;
  const uint16_t* vrp = vr + bk * R * D;
  for (int r = warp; r < rl; r += TILE_WARPS) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = scr[g * R + r];
#pragma unroll
      for (int j = 0; j < DL; ++j)
        ar[g][j] += p * bf16_to_float(vrp[static_cast<size_t>(r) * D + DL * lane + j]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DL; ++j) accw[warp][g][DL * lane + j] = ar[g][j];
  __syncthreads();

#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int idx = tid + k * TILE_THREADS;
    if (idx < G * D) {
      const int g = idx / D, d = idx % D;
      float res = 0.f;
#pragma unroll
      for (int w = 0; w < TILE_WARPS; ++w) res += accw[w][g][d];
      const float l = l_g[g];
      const float val = round_bf16(__fdiv_rn(__fadd_rn(main_o[k], res), l == 0.f ? 1.f : l));
      out[bk * G * D + idx] = static_cast<uint16_t>(__float_as_uint(val) >> 16);
    }
  }
}

// Shared memory of one whole-tile launch (static + dynamic) and the most a
// block of this card may opt in to.
template <int D, int G>
cudaError_t tile_smem(int P, int R, long long* need, long long* avail) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *need = tile_static_bytes<D, G>() + 4LL * G * (static_cast<long long>(P) + R);
  *avail = optin;
  return e;
}

template <int D, int G, bool INT_DOTS, bool KT>
int launch_tile(int B, int KV, int P, int R, cudaStream_t st, const void* q,
                const void* kc, const void* ks, const void* vc,
                const void* vs, const void* kr, const void* vr,
                const void* ml, const void* rl, void* out, float scale) {
  auto kern = int_kv_tile<D, G, INT_DOTS, KT>;
  long long need = 0, avail = 0;
  cudaError_t e = tile_smem<D, G>(P, R, &need, &avail);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (need > avail) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(G) * (P + R) * sizeof(float);
  if (smem + tile_static_bytes<D, G>() > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(KV, B), TILE_THREADS, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const uint16_t*>(kr),
      static_cast<const uint16_t*>(vr), static_cast<const int32_t*>(ml),
      static_cast<const int32_t*>(rl), static_cast<uint16_t*>(out), KV, P, R,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int n_main_splits(int P) {
  return (P + SPLIT_TOKENS - 1) / SPLIT_TOKENS;
}

template <int D, int G, int BITS>
void launch_split(dim3 grid, cudaStream_t st, const void* q, const void* kc,
                  const void* ks, const void* vc, const void* vs,
                  const void* kr, const void* vr, const void* ml,
                  const void* rl, float* mp, float* lp, float* ap, int KV,
                  int P, int R, float scale, int n_main) {
  int_kv_split<D, G, BITS><<<grid, NTHREADS, 0, st>>>(
      static_cast<const uint16_t*>(q), kc,
      static_cast<const float*>(ks), vc,
      static_cast<const float*>(vs), static_cast<const uint16_t*>(kr),
      static_cast<const uint16_t*>(vr), static_cast<const int32_t*>(ml),
      static_cast<const int32_t*>(rl), mp, lp, ap, KV, P, R, scale, n_main);
}

// Calls f(D, G) as std::integral_constants for an instantiated head dim D
// in {64, 128} and group G in {1, 2, 4, 8}; false for any other pair.
template <typename F>
bool with_dg(int D, int G, F&& f) {
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

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of partial results per (batch, head): main-tier splits, then
// residual splits.  The caller sizes the scratch buffers with it.
int int_kv_num_splits(int P, int R) {
  const int n_res = (R + SPLIT_TOKENS - 1) / SPLIT_TOKENS;
  return n_main_splits(P) + n_res;
}

// All tensors contiguous.  m_part/l_part (B, H, NS) and acc_part
// (B, H, NS, D) f32 are scratch, NS = int_kv_num_splits(P, R).
// D in {64, 128}; G = H / KV in {1, 2, 4, 8}; bits 4 (P % 8 == 0) or 8.
int int_kv_decode(const void* q, const void* k_codes, const void* k_scale,
                  const void* v_codes, const void* v_scale, const void* k_res,
                  const void* v_res, const void* main_len, const void* res_len,
                  void* m_part, void* l_part, void* acc_part, void* out, int B,
                  int H, int KV, int D, int P, int R, int bits, float scale,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV || (bits != 4 && bits != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_main = n_main_splits(P);
  const int NS = int_kv_num_splits(P, R);
  dim3 grid(NS, KV, B);
  auto* mp = static_cast<float*>(m_part);
  auto* lp = static_cast<float*>(l_part);
  auto* ap = static_cast<float*>(acc_part);
  const bool taken = with_dg(D, H / KV, [&](auto d, auto g) {
    constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
    auto launch = bits == 4 ? launch_split<DD, GG, 4> : launch_split<DD, GG, 8>;
    launch(grid, st, q, k_codes, k_scale, v_codes, v_scale, k_res, v_res,
           main_len, res_len, mp, lp, ap, KV, P, R, scale, n_main);
  });
  if (!taken) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int_kv_merge<<<B * H, D, 0, st>>>(mp, lp, ap, static_cast<uint16_t*>(out),
                                    NS, D);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a whole-tile launch at (D, G, P, R) needs, static arrays
// and dynamic scores, in *need; the most this card lets a block opt in to,
// in *avail.  The caller refuses a shape whose need exceeds it.
int int_kv_tile_smem(int D, int G, int P, int R, long long* need,
                     long long* avail) {
  cudaError_t e = cudaErrorInvalidValue;
  with_dg(D, G, [&](auto d, auto g) {
    e = tile_smem<decltype(d)::value, decltype(g)::value>(P, R, need, avail);
  });
  return static_cast<int>(e);
}

// The integer-dot (int_dots) and K^T (k_transposed) forms at int8 codes:
// one block per (batch, kv head), no scratch.  k_codes is (B, KV, D, P)
// when k_transposed, else (B, KV, P, D); D in {64, 128}, G = H / KV in
// {1, 2, 4, 8}, P % 8 == 0, every pointer 16-byte aligned, and the shared
// memory of int_kv_tile_smem within the card's opt-in maximum.
int int_kv_decode_tile(const void* q, const void* k_codes, const void* k_scale,
                       const void* v_codes, const void* v_scale,
                       const void* k_res, const void* v_res,
                       const void* main_len, const void* res_len, void* out,
                       int B, int H, int KV, int D, int P, int R, int int_dots,
                       int k_transposed, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV || P % 8 || !(int_dots || k_transposed))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  with_dg(D, H / KV, [&](auto d, auto g) {
    constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
    auto launch = int_dots ? (k_transposed ? launch_tile<DD, GG, true, true>
                                           : launch_tile<DD, GG, true, false>)
                           : launch_tile<DD, GG, false, true>;
    err = launch(B, KV, P, R, st, q, k_codes, k_scale, v_codes, v_scale,
                 k_res, v_res, main_len, res_len, out, scale);
  });
  return err;
}

}  // extern "C"
