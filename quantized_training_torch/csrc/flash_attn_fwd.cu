// Causal GQA flash attention forward, in two forms:
//   flash_attn_fwd: single pass, online softmax, no rounding hooks;
//   flash_attn_fwd_two_pass: the probabilities rounded to a format
//     (p_qfn) and, optionally, the output rounded in the epilogue (out_qfn).
//   q (B, H, S, D), k/v (B, KV, T, D) bf16, out (B, H, S, D) bf16;
//   query row i sits at absolute position q_offset + i; head h reads kv head
//   h / (H / KV); f32 softmax statistics; masked scores are NEG_INF = -2^30.
//
// Replaces quantized_training_tpu/ops/pallas/flash_attention.py:66
// (_attn_kernel, reached through flash_attention).  Single pass: p is
// rounded to bf16 before the p @ v product, as the TPU kernel rounds it to
// v's dtype, and a row whose l is 0 divides by 1.  Two pass (the TPU
// kernel's p_qfn form, :160-216): pass 1 keeps the running max and sum of
// each row and turns them into its logsumexp; pass 2 recomputes each score
// tile, rounds p = exp(s - lse) to bf16 and then through the p format
// (qt_round.cuh), and accumulates round(p) @ v with no final division; the
// out format, if any, rounds the bf16 output before the store.
//
// What bounds it on an H100: the causal operations, 4*S^2*D*H/2 per batch
// row for one pass and 6*S^2*D*H/2 for two (pass 1 computes scores only),
// over the 989 TFLOP/s bf16 tensor-core rate; the score tensor never leaves
// the block.  Design for this first version (CUDA-core FMAs, no tensor
// cores yet): one block of four warps per (64-row q tile, head, batch); K/V
// tiles of 32 keys are staged in shared memory (K transposed so that lane j
// reads key j without bank conflicts); each warp owns 16 query rows and
// keeps their running max, sum and output accumulators in registers (lane j
// holds score column j, then output columns j + 32i); key tiles above the
// diagonal are never loaded, in either pass, and pass 1 loads no V.  Any S
// and T are taken (ragged tiles are masked), and D is 64 or 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qt_round.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NWARPS = 4;
constexpr int ROWS = BQ / NWARPS;  // query rows per warp
constexpr int KT_STRIDE = BK + 2;  // padded row of the transposed K tile
constexpr float NEG_INF = -1073741824.0f;  // -2^30

__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
struct Tiles {
  __align__(16) uint16_t qs[BQ][D];
  __align__(16) uint16_t kts[D][KT_STRIDE];
  __align__(16) uint16_t vs[BK][D];
  float ps[BQ][BK];
};

// q tile, zero past S
template <int D>
__device__ __forceinline__ void load_q(Tiles<D>& t, const uint16_t* qp, int q0,
                                       int S, int tid) {
  for (int idx = tid; idx < BQ * D / 8; idx += NWARPS * 32) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(qp + static_cast<size_t>(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(&t.qs[r][c]) = val;
  }
}

// K tile (transposed) and, with LOAD_V, the V tile of keys k0..k0+BK-1,
// zero past T
template <int D, bool LOAD_V>
__device__ __forceinline__ void load_kv(Tiles<D>& t, const uint16_t* kp,
                                        const uint16_t* vp, int k0, int T,
                                        int tid) {
  for (int idx = tid; idx < BK * D / 8; idx += NWARPS * 32) {
    const int c = idx / (D / 8);
    const int d = (idx % (D / 8)) * 8;
    uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
    if (k0 + c < T) {
      kv4 = *reinterpret_cast<const uint4*>(kp + static_cast<size_t>(k0 + c) * D + d);
      if (LOAD_V)
        vv4 = *reinterpret_cast<const uint4*>(vp + static_cast<size_t>(k0 + c) * D + d);
    }
    const uint32_t kw[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.kts[d + 2 * e][c] = static_cast<uint16_t>(kw[e] & 0xffffu);
      t.kts[d + 2 * e + 1][c] = static_cast<uint16_t>(kw[e] >> 16);
    }
    if (LOAD_V) *reinterpret_cast<uint4*>(&t.vs[c][d]) = vv4;
  }
}

// raw scores q . k of the warp's rows r0.. against key column `lane`
template <int D>
__device__ __forceinline__ void score_tile(const Tiles<D>& t, int r0, int lane,
                                           float (&s)[ROWS]) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
  for (int d = 0; d < D; d += 8) {
    float kv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) kv[e] = bf16_to_float(t.kts[d + e][lane]);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const uint4 qv = *reinterpret_cast<const uint4*>(&t.qs[r0 + i][d]);
      const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
      float a = s[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a += __uint_as_float(qw[e] << 16) * kv[2 * e];
        a += __uint_as_float(qw[e] & 0xffff0000u) * kv[2 * e + 1];
      }
      s[i] = a;
    }
  }
}

// acc += ps[rows] @ vs (output columns lane + 32j)
template <int D>
__device__ __forceinline__ void accumulate_pv(const Tiles<D>& t, int r0, int lane,
                                              float (&acc)[ROWS][D / 32]) {
  constexpr int DL = D / 32;
  for (int c = 0; c < BK; ++c) {
    float vv[DL];
#pragma unroll
    for (int j = 0; j < DL; ++j) vv[j] = bf16_to_float(t.vs[c][lane + 32 * j]);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float p = t.ps[r0 + i][c];
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[i][j] += p * vv[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
          const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int H,
          int KV, int S, int T, float scale, int causal, int q_offset) {
  constexpr int DL = D / 32;  // output columns per lane
  __shared__ Tiles<D> t;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const uint16_t* qp = q + (static_cast<size_t>(b) * H + h) * S * D;
  const uint16_t* kp = k + (static_cast<size_t>(b) * KV + kvh) * T * D;
  const uint16_t* vp = v + (static_cast<size_t>(b) * KV + kvh) * T * D;
  uint16_t* op = o + (static_cast<size_t>(b) * H + h) * S * D;

  load_q<D>(t, qp, q0, S, tid);

  const int r0 = warp * ROWS;
  float m[ROWS], l[ROWS], acc[ROWS][DL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[i][j] = 0.f;
  }

  // keys a causal tile can see: positions <= q_offset + last row
  const int q_last = min(q0 + BQ, S) - 1;
  const int kend = causal ? max(0, min(T, q_offset + q_last + 1)) : T;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    load_kv<D, true>(t, kp, vp, k0, T, tid);
    __syncthreads();

    float s[ROWS];
    score_tile<D>(t, r0, lane, s);

    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q_offset + q0 + r0 + i;
      const bool valid = kpos < T && (!causal || kpos <= qpos);
      const float sv = valid ? s[i] * scale : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = m_new;
      t.ps[r0 + i][lane] = round_bf16(p);
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();
    accumulate_pv<D>(t, r0, lane, acc);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DL; ++j) {
      const float val = round_bf16(acc[i][j] / denom);
      op[static_cast<size_t>(row) * D + lane + 32 * j] =
          static_cast<uint16_t>(__float_as_uint(val) >> 16);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_two_pass(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                   int H, int KV, int S, int T, float scale, int causal,
                   int q_offset, QtFormat p_fmt, QtFormat out_fmt) {
  constexpr int DL = D / 32;
  __shared__ Tiles<D> t;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const uint16_t* qp = q + (static_cast<size_t>(b) * H + h) * S * D;
  const uint16_t* kp = k + (static_cast<size_t>(b) * KV + kvh) * T * D;
  const uint16_t* vp = v + (static_cast<size_t>(b) * KV + kvh) * T * D;
  uint16_t* op = o + (static_cast<size_t>(b) * H + h) * S * D;

  load_q<D>(t, qp, q0, S, tid);

  const int r0 = warp * ROWS;
  const int q_last = min(q0 + BQ, S) - 1;
  const int kend = causal ? max(0, min(T, q_offset + q_last + 1)) : T;

  // pass 1: running max and sum, then the row logsumexp
  float lse[ROWS];
  {
    float l[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      lse[i] = NEG_INF;
      l[i] = 0.f;
    }
    for (int k0 = 0; k0 < kend; k0 += BK) {
      __syncthreads();
      load_kv<D, false>(t, kp, vp, k0, T, tid);
      __syncthreads();
      float s[ROWS];
      score_tile<D>(t, r0, lane, s);
      const int kpos = k0 + lane;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int qpos = q_offset + q0 + r0 + i;
        const bool valid = kpos < T && (!causal || kpos <= qpos);
        const float sv = valid ? s[i] * scale : NEG_INF;
        const float m_new = fmaxf(lse[i], warp_max(sv));
        const float p = valid ? expf(sv - m_new) : 0.f;
        l[i] = l[i] * expf(lse[i] - m_new) + warp_sum(p);
        lse[i] = m_new;
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) lse[i] += logf(l[i] == 0.f ? 1.f : l[i]);
  }

  // pass 2: acc += round(exp(s - lse)) @ v, no rescale and no division
  float acc[ROWS][DL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_kv<D, true>(t, kp, vp, k0, T, tid);
    __syncthreads();
    float s[ROWS];
    score_tile<D>(t, r0, lane, s);
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q_offset + q0 + r0 + i;
      const bool valid = kpos < T && (!causal || kpos <= qpos);
      const float p = valid ? expf(s[i] * scale - lse[i]) : 0.f;
      t.ps[r0 + i][lane] = qt_round<true>(round_bf16(p), p_fmt);
    }
    __syncwarp();
    accumulate_pv<D>(t, r0, lane, acc);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + r0 + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DL; ++j) {
      const float val = qt_round<true>(round_bf16(acc[i][j]), out_fmt);
      op[static_cast<size_t>(row) * D + lane + 32 * j] =
          static_cast<uint16_t>(__float_as_uint(val) >> 16);
    }
  }
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, H, S, D), k/v (B, KV, T, D), out (B, H, S, D): contiguous bf16,
// 16-byte aligned; H % KV == 0; D in {64, 128}.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KV, int S, int T, int D, float scale,
                   int causal, int q_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  auto* op = static_cast<uint16_t*>(out);
  if (D == 128) {
    flash_fwd<128><<<grid, NWARPS * 32, 0, st>>>(qp, kp, vp, op, H, KV, S, T,
                                                 scale, causal, q_offset);
  } else if (D == 64) {
    flash_fwd<64><<<grid, NWARPS * 32, 0, st>>>(qp, kp, vp, op, H, KV, S, T,
                                                scale, causal, q_offset);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As flash_attn_fwd, with p rounded to p_fmt and the output to out_fmt
// (kind QT_NONE: no output rounding).
int flash_attn_fwd_two_pass(const void* q, const void* k, const void* v,
                            void* out, int B, int H, int KV, int S, int T,
                            int D, float scale, int causal, int q_offset,
                            QtFormat p_fmt, QtFormat out_fmt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  auto* op = static_cast<uint16_t*>(out);
  if (D == 128) {
    flash_fwd_two_pass<128><<<grid, NWARPS * 32, 0, st>>>(
        qp, kp, vp, op, H, KV, S, T, scale, causal, q_offset, p_fmt, out_fmt);
  } else if (D == 64) {
    flash_fwd_two_pass<64><<<grid, NWARPS * 32, 0, st>>>(
        qp, kp, vp, op, H, KV, S, T, scale, causal, q_offset, p_fmt, out_fmt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
