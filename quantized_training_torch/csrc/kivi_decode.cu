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
// about 21 MB or 6.3 us for Phi-3-medium, KV = 10, G = 4: 10.5 MB of words,
// 5.2 MB of qparams, 5.2 MB of ring).  As in csrc/int_kv_decode.cu the tokens
// are split over blocks (flash-decoding): each block takes 32 word rows of
// the main tier (512 uint2 or 256 uint4 tokens; 256 tokens of bytes) or 256
// rows of the residual ring for one (batch, kv head) and all G query heads
// of it, writes a partial (max,
// sum, f32 accumulator, f32 V zero-point term) per query head, and a merge
// kernel combines them; the V zero-point term is merged before it is rounded
// to bf16, as the TPU rounds it once over all tokens.  p is rounded against
// each split's own max (the TPU: the global max).  The K zero-point constant
// q . bf16((mid - kz[g]) ks[g]) of each token group the split touches is
// computed once per block and query head into shared memory, all G heads
// against the one kz/ks of their kv head; word rows holding no token below
// main_len are never read.
// A warp reads whole rows (lane j holds features DL*j .. DL*j + DL - 1) and
// sign-extends a field with a left shift of the unsigned word and an
// arithmetic right shift of its int32 reinterpretation.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RES_TOKENS = 256;            // residual rows per block
constexpr int MAX_TOKENS = 512;            // main tokens per block, at most
constexpr int MAX_GROUPS = 256;            // K token groups per (b, kv head)
constexpr float NEG_INF = -1073741824.0f;  // -2^30

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

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) r += red[w];
  return r;
}

// Word rows per block and tokens per word row.
template <int BITS> struct Tier {
  static constexpr int PER = BITS ? 32 / BITS : 1;
  static constexpr int ROWS = BITS ? 32 : 256;
  static constexpr int MID = BITS ? 1 << (BITS - 1) : 0;
};

// The DL codes of one lane in one word row: packed words or bytes.
template <int BITS, int DL> struct Row {
  uint32_t w[DL];
  __device__ __forceinline__ void load(const void* base, size_t row, int D,
                                       int lane) {
    if (BITS) {
      const int32_t* p = static_cast<const int32_t*>(base) + row * D + DL * lane;
#pragma unroll
      for (int j = 0; j < DL; ++j) w[j] = static_cast<uint32_t>(p[j]);
    } else {
      const uint8_t* p = static_cast<const uint8_t*>(base) + row * D + DL * lane;
#pragma unroll
      for (int j = 0; j < DL; ++j) w[j] = p[j];
    }
  }
  // centered code of field s (the raw byte when BITS == 0)
  __device__ __forceinline__ float code(int j, int s) const {
    if (BITS == 0) return static_cast<float>(w[j]);
    return static_cast<float>(static_cast<int32_t>(w[j] << (32 - BITS * (s + 1))) >>
                              (32 - BITS));
  }
};

template <int D, int G, int BITS>
__global__ void __launch_bounds__(NTHREADS)
kivi_split(const uint16_t* __restrict__ q, const void* __restrict__ kc,
           const uint16_t* __restrict__ ks, const uint16_t* __restrict__ kz,
           const void* __restrict__ vc, const uint16_t* __restrict__ vs,
           const uint16_t* __restrict__ vz, const uint16_t* __restrict__ kr,
           const uint16_t* __restrict__ vr, const int32_t* __restrict__ main_len,
           const int32_t* __restrict__ res_len, float* __restrict__ m_part,
           float* __restrict__ l_part, float* __restrict__ acc_part,
           float* __restrict__ o2_part, int KV, int P, int R, int gP, int gD,
           float scale, int n_main) {
  constexpr int DL = D / 32;
  constexpr int PER = Tier<BITS>::PER;
  constexpr int ROWS = Tier<BITS>::ROWS;
  constexpr int MID = Tier<BITS>::MID;
  constexpr int TOK = (ROWS * PER > RES_TOKENS) ? ROWS * PER : RES_TOKENS;
  static_assert(ROWS * PER <= MAX_TOKENS, "split too large");
  static_assert(D % 32 == 0, "a warp covers a row");
  static_assert(NWARPS * 32 <= MAX_GROUPS, "o2sh fits in kcs");
  // qsh, sc, kcs (o2sh), red and accsh: 44.0 KB at G = 8, D = 128, uint2
  static_assert(4 * (G * D + G * TOK + G * MAX_GROUPS + NWARPS + NWARPS * G * D)
                <= 48 * 1024, "static shared memory");
  __shared__ float qsh[G][D];
  __shared__ float sc[G][TOK];
  // kcs[g][gk]: the K zero-point constants, read only by the scores; the
  // same memory then holds o2sh[warp][g][lane], the V zero-point partials
  __shared__ float kcs_o2[G * MAX_GROUPS];
  __shared__ float red[NWARPS];
  __shared__ float accsh[NWARPS][G][D];
  float (*kcs)[MAX_GROUPS] = reinterpret_cast<float (*)[MAX_GROUPS]>(kcs_o2);
  float (*o2sh)[G][32] = reinterpret_cast<float (*)[G][32]>(kcs_o2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = KV * G;
  const int NS = gridDim.x;
  const int Pw = P / PER;
  const int bsK = P / gP;
  const int bsV = D / gD;
  const int ml = min(max(main_len[b], 0), P);
  const int rl = min(max(res_len[b], 0), R);
  const size_t bk = static_cast<size_t>(b) * KV + kvh;

  const bool is_main = split < n_main;
  const int w0 = split * ROWS;                       // main: rows [w0, w1)
  const int w1 = min(min(w0 + ROWS, Pw), ml);
  const int r0 = (split - n_main) * RES_TOKENS;      // residual: [r0, r1)
  const int r1 = min(r0 + RES_TOKENS, rl);
  const bool empty = is_main ? (w0 >= w1) : (r0 >= r1);

  if (empty) {  // block-uniform
    for (int idx = tid; idx < G * D; idx += NTHREADS) {
      const int g = idx / D, d = idx % D;
      const size_t hs = (static_cast<size_t>(b) * H + kvh * G + g) * NS + split;
      acc_part[hs * D + d] = 0.f;
      if (d < gD) o2_part[hs * gD + d] = 0.f;
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
  for (int idx = tid; idx < G * TOK; idx += NTHREADS) sc[idx / TOK][idx % TOK] = NEG_INF;
  __syncthreads();

  float qreg[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DL; ++j) qreg[g][j] = qsh[g][DL * lane + j];

  if (is_main) {
    // ---- K zero-point constants of the groups this block touches ---------
    // plane s holds tokens [s*Pw + w0, s*Pw + w1); a group is computed once
    // per plane that reaches it (neighbouring planes may repeat a group and
    // write the same value).
    const uint16_t* ksp = ks + bk * gP * D;
    const uint16_t* kzp = kz + bk * gP * D;
    const int span = (ROWS + bsK - 1) / bsK + 1;     // groups per plane run
    for (int item = warp; item < PER * span; item += NWARPS) {
      const int s = item / span;
      const int t0 = s * Pw + w0;
      const int t1 = min(s * Pw + w1, ml);
      const int gk = t0 / bsK + item % span;
      if (t0 >= t1 || gk * bsK >= t1) continue;      // warp-uniform
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
      for (int j = 0; j < DL; ++j) {
        const size_t o = static_cast<size_t>(gk) * D + DL * lane + j;
        const float sv = bf16_to_float(ksp[o]);
        const float w = round_bf16((static_cast<float>(MID) - bf16_to_float(kzp[o])) * sv);
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] += qreg[g][j] * w;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float c = warp_sum(part[g]);
        if (lane == 0) kcs[g][gk] = round_bf16(c);
      }
    }
    __syncthreads();

    // ---- main-tier scores ------------------------------------------------
    for (int t = w0 + warp; t < w1; t += NWARPS) {
      Row<BITS, DL> row;
      row.load(kc, bk * Pw + t, D, lane);
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        const int tok = s * Pw + t;
        if (tok >= ml) break;                        // warp-uniform
        const int gk = tok / bsK;
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
        for (int j = 0; j < DL; ++j) {
          const float sv = bf16_to_float(ksp[static_cast<size_t>(gk) * D + DL * lane + j]);
          const float khat = round_bf16(row.code(j, s) * sv);
#pragma unroll
          for (int g = 0; g < G; ++g) part[g] += qreg[g][j] * khat;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float sdot = warp_sum(part[g]);
          if (lane == 0) sc[g][s * ROWS + (t - w0)] = sdot + kcs[g][gk];
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

  // ---- softmax statistics of this split; p rounded to bf16 ---------------
  float m_g[G], l_g[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = NEG_INF;
    for (int i = tid; i < TOK; i += NTHREADS) mx = fmaxf(mx, sc[g][i]);
    m_g[g] = block_max(mx, red);
    float sum = 0.f;
    for (int i = tid; i < TOK; i += NTHREADS) {
      const float sv = sc[g][i];
      float p = 0.f;
      if (sv != NEG_INF) p = expf(sv - m_g[g]);
      sum += p;
      sc[g][i] = round_bf16(p);  // each thread rewrites only entries it read
    }
    l_g[g] = block_sum(sum, red);
  }
  __syncthreads();

  // ---- weighted values ---------------------------------------------------
  float acc[G][DL], o2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    o2[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[g][j] = 0.f;
  }
  if (is_main) {
    const int gg = (DL * lane) / bsV;              // this lane's V group
    const uint16_t* vsp = vs + bk * P * gD + gg;
    const uint16_t* vzp = vz + bk * P * gD + gg;
    for (int t = w0 + warp; t < w1; t += NWARPS) {
      Row<BITS, DL> row;
      row.load(vc, bk * Pw + t, D, lane);
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        const int tok = s * Pw + t;
        if (tok >= ml) break;                        // warp-uniform
        const float sv = bf16_to_float(vsp[static_cast<size_t>(tok) * gD]);
        const float zv = bf16_to_float(vzp[static_cast<size_t>(tok) * gD]);
        const float w2 = round_bf16((static_cast<float>(MID) - zv) * sv);
        float vhat[DL];
#pragma unroll
        for (int j = 0; j < DL; ++j) vhat[j] = round_bf16(row.code(j, s) * sv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sc[g][s * ROWS + (t - w0)];
          o2[g] += p * w2;
#pragma unroll
          for (int j = 0; j < DL; ++j) acc[g][j] += p * vhat[j];
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
  for (int g = 0; g < G; ++g) {
    o2sh[warp][g][lane] = o2[g];
#pragma unroll
    for (int j = 0; j < DL; ++j) accsh[warp][g][DL * lane + j] = acc[g][j];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += NTHREADS) {
    const int g = idx / D, d = idx % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) a += accsh[w][g][d];
    const size_t hs = (static_cast<size_t>(b) * H + kvh * G + g) * NS + split;
    acc_part[hs * D + d] = a;
    if (d < gD) {  // V group d: the first lane of that group holds its sum
      const int ln = d * bsV / DL;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) o += o2sh[w][g][ln];
      o2_part[hs * gD + d] = o;
    }
    if (d == 0) {
      m_part[hs] = m_g[g];
      l_part[hs] = l_g[g];
    }
  }
}

// one block of D threads per (batch, head):
//   out = (sum_s w_s acc_s + bf16(sum_s w_s o2_s)) / sum_s w_s l_s
__global__ void kivi_merge(const float* __restrict__ m_part,
                           const float* __restrict__ l_part,
                           const float* __restrict__ acc_part,
                           const float* __restrict__ o2_part,
                           uint16_t* __restrict__ out, int NS, int D, int gD) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const int gg = d / (D / gD);
  const float* mp = m_part + bh * NS;
  const float* lp = l_part + bh * NS;
  float mx = NEG_INF;
  for (int s = 0; s < NS; ++s)
    if (lp[s] > 0.f) mx = fmaxf(mx, mp[s]);
  float l = 0.f, a = 0.f, o = 0.f;
  for (int s = 0; s < NS; ++s) {
    if (lp[s] > 0.f) {
      const float w = expf(mp[s] - mx);
      l += w * lp[s];
      a += w * acc_part[(bh * NS + s) * D + d];
      o += w * o2_part[(bh * NS + s) * gD + gg];
    }
  }
  const float val = round_bf16((a + round_bf16(o)) / (l == 0.f ? 1.f : l));
  out[bh * D + d] = static_cast<uint16_t>(__float_as_uint(val) >> 16);
}

int n_main_splits(int P, int bits) {
  const int per = bits ? 32 / bits : 1;
  const int rows = bits ? 32 : 256;
  return (P / per + rows - 1) / rows;
}

template <int D, int G, int BITS>
void launch_split(dim3 grid, cudaStream_t st, const void* const* t, float* mp,
                  float* lp, float* ap, float* op, int KV, int P, int R,
                  int gP, int gD, float scale, int n_main) {
  kivi_split<D, G, BITS><<<grid, NTHREADS, 0, st>>>(
      static_cast<const uint16_t*>(t[0]), t[1],
      static_cast<const uint16_t*>(t[2]), static_cast<const uint16_t*>(t[3]),
      t[4], static_cast<const uint16_t*>(t[5]),
      static_cast<const uint16_t*>(t[6]), static_cast<const uint16_t*>(t[7]),
      static_cast<const uint16_t*>(t[8]), static_cast<const int32_t*>(t[9]),
      static_cast<const int32_t*>(t[10]), mp, lp, ap, op, KV, P, R, gP, gD,
      scale, n_main);
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

// Partial results per (batch, head): main-tier splits, then residual
// splits.  The caller sizes the scratch buffers with it.
int kivi_num_splits(int P, int R, int bits) {
  return n_main_splits(P, bits) + (R + RES_TOKENS - 1) / RES_TOKENS;
}

// All tensors contiguous.  m_part/l_part (B, H, NS), acc_part (B, H, NS, D)
// and o2_part (B, H, NS, gD) f32 are scratch, NS = kivi_num_splits(P, R,
// bits).  D in {64, 128}, G = H / KV in {1, 2, 4, 8}; bits_k == bits_v in
// {0, 2, 4} (0: uint8 codes); at most 256 K groups (gP); (D/gD) % (D/32)
// == 0 (a V group spans whole lanes).
int kivi_decode(const void* q, const void* k_codes, const void* k_scale,
                const void* k_zp, const void* v_codes, const void* v_scale,
                const void* v_zp, const void* k_res, const void* v_res,
                const void* main_len, const void* res_len, void* m_part,
                void* l_part, void* acc_part, void* o2_part, void* out, int B,
                int H, int KV, int D, int P, int R, int gP, int gD, int bits_k,
                int bits_v, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bits = bits_k;
  if (bits_k != bits_v || (bits != 0 && bits != 2 && bits != 4) ||
      gP > MAX_GROUPS || gP <= 0 || gD <= 0 || KV <= 0 || H % KV ||
      D % gD || (D / gD) % (D / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_main = n_main_splits(P, bits);
  const int NS = kivi_num_splits(P, R, bits);
  dim3 grid(NS, KV, B);
  const void* t[11] = {q, k_codes, k_scale, k_zp, v_codes, v_scale, v_zp,
                       k_res, v_res, main_len, res_len};
  auto* mp = static_cast<float*>(m_part);
  auto* lp = static_cast<float*>(l_part);
  auto* ap = static_cast<float*>(acc_part);
  auto* op = static_cast<float*>(o2_part);
  const bool taken = with_dg(D, H / KV, [&](auto d, auto g) {
    constexpr int DD = decltype(d)::value, GG = decltype(g)::value;
    auto launch = bits == 2 ? launch_split<DD, GG, 2>
                : bits == 4 ? launch_split<DD, GG, 4> : launch_split<DD, GG, 0>;
    launch(grid, st, t, mp, lp, ap, op, KV, P, R, gP, gD, scale, n_main);
  });
  if (!taken) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kivi_merge<<<B * H, D, 0, st>>>(mp, lp, ap, op, static_cast<uint16_t*>(out),
                                  NS, D, gD);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
