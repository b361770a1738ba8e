// One decode step of attention over the two-tier int4 per-token-symmetric
// KV cache: a quantized main tier plus a bf16 residual ring.
//   q (B, H, D) bf16; k/v codes (B, KV, P/8, D) int32, token-planar: bit
//   field s of word row t' holds the 4-bit two's-complement code of token
//   s*(P/8) + t'; ks/vs (B, KV, 1, P) f32 per-token scales; k/v residual
//   (B, KV, R, D) bf16; main_len/res_len (B,) int32.  Out (B, H, D) bf16.
//   qb = bf16(q * scale);  s_main[t] = (qb . c_k[t]) * ks[t], t < main_len;
//   s_res[r] = qb . k_res[r], r < res_len;  one softmax over both tiers;
//   out = (sum_t bf16(p_t * vs[t]) c_v[t] + sum_r bf16(p_r) v_res[r]) / l.
//
// Replaces quantized_training_tpu/ops/pallas/int_kv_attention.py:77
// (_kernel, reached through int_kv_decode_attention) in the form serving
// runs: bits=4, bf16 dots (int_dots=False), untransposed K.
//
// What bounds it on an H100: the bytes of the codes, scales and residual
// ring over 3.35 TB/s (about 88 MB per layer at 8 full slots of LLaMA-2 7B).
// The TPU grid is one program per (batch, kv head) -- 256 here, too few to
// keep 132 SMs' memory pipes busy -- so this kernel splits the tokens
// (flash-decoding): each block takes 32 word rows (256 tokens) of the main
// tier, or 256 rows of the residual ring, for one (batch, kv head), keeps
// its scores in shared memory, and writes a partial (max, sum, f32
// accumulator) per head; a second small kernel merges the partials.  Word
// rows holding no token below main_len are never read (plane 0 holds the
// lowest token of a word row), so a short prompt costs only its own bytes.
// Each warp reads whole 512-byte word rows (lane j holds d = 4j..4j+3) and
// sign-extends a field with a left shift of the unsigned word and an
// arithmetic right shift of its int32 reinterpretation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SPLIT_WORDS = 32;              // main-tier word rows per block
constexpr int SPLIT_TOKENS = 8 * SPLIT_WORDS;  // tokens per block, both tiers
constexpr float NEG_INF = -1073741824.0f;    // -2^30

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

__device__ __forceinline__ int code_of(uint32_t word, int s) {
  return static_cast<int32_t>(word << (28 - 4 * s)) >> 28;
}

// block-wide max and sum over NTHREADS lanes (red holds NWARPS floats)
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

// G: query heads per kv head; D: head dim (DL = D/32 values per lane).
// int_kv_decode instantiates D=128, G=1, the LLaMA-2 7B geometry.
template <int D, int G>
__global__ void __launch_bounds__(NTHREADS)
int_kv_split(const uint16_t* __restrict__ q, const int32_t* __restrict__ kc,
             const float* __restrict__ ks, const int32_t* __restrict__ vc,
             const float* __restrict__ vsc, const uint16_t* __restrict__ kr,
             const uint16_t* __restrict__ vr, const int32_t* __restrict__ main_len,
             const int32_t* __restrict__ res_len, float* __restrict__ m_part,
             float* __restrict__ l_part, float* __restrict__ acc_part, int KV,
             int P, int R, float scale, int n_main) {
  constexpr int DL = D / 32;
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
  const int Pw = P / 8;
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
    const int32_t* kcp = kc + bk * Pw * D;
    const float* ksp = ks + bk * P;
    for (int t = w0 + warp; t < w1; t += NWARPS) {
      int32_t wv[DL];
#pragma unroll
      for (int j = 0; j < DL; ++j) wv[j] = kcp[static_cast<size_t>(t) * D + DL * lane + j];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int tok = s * Pw + t;
        float part[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < DL; ++j)
            a += qreg[g][j] * static_cast<float>(code_of(static_cast<uint32_t>(wv[j]), s));
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
    const int32_t* vcp = vc + bk * Pw * D;
    for (int t = w0 + warp; t < w1; t += NWARPS) {
      int32_t wv[DL];
#pragma unroll
      for (int j = 0; j < DL; ++j) wv[j] = vcp[static_cast<size_t>(t) * D + DL * lane + j];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pv = sc[g][s * SPLIT_WORDS + (t - w0)];
#pragma unroll
          for (int j = 0; j < DL; ++j)
            acc[g][j] += pv * static_cast<float>(code_of(static_cast<uint32_t>(wv[j]), s));
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

template <int D, int G>
void launch_split(dim3 grid, cudaStream_t st, const void* q, const void* kc,
                  const void* ks, const void* vc, const void* vs,
                  const void* kr, const void* vr, const void* ml,
                  const void* rl, float* mp, float* lp, float* ap, int KV,
                  int P, int R, float scale, int n_main) {
  int_kv_split<D, G><<<grid, NTHREADS, 0, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const int32_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int32_t*>(vc),
      static_cast<const float*>(vs), static_cast<const uint16_t*>(kr),
      static_cast<const uint16_t*>(vr), static_cast<const int32_t*>(ml),
      static_cast<const int32_t*>(rl), mp, lp, ap, KV, P, R, scale, n_main);
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of partial results per (batch, head): main-tier splits, then
// residual splits.  The caller sizes the scratch buffers with it.
int int_kv_num_splits(int P, int R) {
  const int n_main = (P / 8 + SPLIT_WORDS - 1) / SPLIT_WORDS;
  const int n_res = (R + SPLIT_TOKENS - 1) / SPLIT_TOKENS;
  return n_main + n_res;
}

// All tensors contiguous.  m_part/l_part (B, H, NS) and acc_part
// (B, H, NS, D) f32 are scratch, NS = int_kv_num_splits(P, R).
// D == 128; H == KV (no GQA); P % 8 == 0.
int int_kv_decode(const void* q, const void* k_codes, const void* k_scale,
                  const void* v_codes, const void* v_scale, const void* k_res,
                  const void* v_res, const void* main_len, const void* res_len,
                  void* m_part, void* l_part, void* acc_part, void* out, int B,
                  int H, int KV, int D, int P, int R, float scale,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_main = (P / 8 + SPLIT_WORDS - 1) / SPLIT_WORDS;
  const int NS = int_kv_num_splits(P, R);
  const int G = H / KV;
  dim3 grid(NS, KV, B);
  auto* mp = static_cast<float*>(m_part);
  auto* lp = static_cast<float*>(l_part);
  auto* ap = static_cast<float*>(acc_part);
#define QT_LAUNCH(DD, GG)                                                    \
  launch_split<DD, GG>(grid, st, q, k_codes, k_scale, v_codes, v_scale,      \
                       k_res, v_res, main_len, res_len, mp, lp, ap, KV, P, R, \
                       scale, n_main)
  // Only the served geometry is instantiated (and checked on the card);
  // another (D, G) pair is one more line here and one more check.
  if (D == 128 && G == 1) QT_LAUNCH(128, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef QT_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int_kv_merge<<<B * H, D, 0, st>>>(mp, lp, ap, static_cast<uint16_t*>(out),
                                    NS, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
