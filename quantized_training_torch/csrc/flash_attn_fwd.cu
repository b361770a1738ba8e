// Causal GQA flash attention forward, single pass, no quantization hooks.
//   q (B, H, S, D), k/v (B, KV, T, D) bf16, out (B, H, S, D) bf16;
//   query row i sits at absolute position q_offset + i; head h reads kv head
//   h / (H / KV); f32 online softmax; masked scores are NEG_INF = -2^30.
//
// Replaces quantized_training_tpu/ops/pallas/flash_attention.py:66
// (_attn_kernel, reached through flash_attention) in its single-pass,
// hook-free form: p is rounded to bf16 before the p @ v product, as the TPU
// kernel rounds it to v's dtype, and a row whose l is 0 divides by 1.
//
// What bounds it on an H100: the 4*S^2*D*H/2 causal operations (per batch
// row) over the 989 TFLOP/s bf16 tensor-core rate; the score tensor never
// leaves the block.  Design for this first version (CUDA-core FMAs, no
// tensor cores yet): one block of four warps per (64-row q tile, head,
// batch); K/V tiles of 32 keys are staged in shared memory (K transposed so
// that lane j reads key j without bank conflicts); each warp owns 16 query
// rows and keeps their running max, sum and output accumulators in
// registers (lane j holds score column j, then output columns j + 32i);
// key tiles above the diagonal are never loaded.  Any S and T are taken
// (ragged tiles are masked), and D is 64 or 128.

#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
          const uint16_t* __restrict__ v, uint16_t* __restrict__ o, int H,
          int KV, int S, int T, float scale, int causal, int q_offset) {
  constexpr int DL = D / 32;  // output columns per lane
  __shared__ __align__(16) uint16_t qs[BQ][D];
  __shared__ __align__(16) uint16_t kts[D][KT_STRIDE];
  __shared__ __align__(16) uint16_t vs[BK][D];
  __shared__ float ps[BQ][BK];

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

  // q tile, zero past S
  for (int idx = tid; idx < BQ * D / 8; idx += NWARPS * 32) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(qp + static_cast<size_t>(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(&qs[r][c]) = val;
  }

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
    for (int idx = tid; idx < BK * D / 8; idx += NWARPS * 32) {
      const int c = idx / (D / 8);
      const int d = (idx % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k0 + c < T) {
        kv4 = *reinterpret_cast<const uint4*>(kp + static_cast<size_t>(k0 + c) * D + d);
        vv4 = *reinterpret_cast<const uint4*>(vp + static_cast<size_t>(k0 + c) * D + d);
      }
      const uint32_t kw[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kts[d + 2 * e][c] = static_cast<uint16_t>(kw[e] & 0xffffu);
        kts[d + 2 * e + 1][c] = static_cast<uint16_t>(kw[e] >> 16);
      }
      *reinterpret_cast<uint4*>(&vs[c][d]) = vv4;
    }
    __syncthreads();

    // scores: lane = key column
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    for (int d = 0; d < D; d += 8) {
      float kv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) kv[e] = bf16_to_float(kts[d + e][lane]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const uint4 qv = *reinterpret_cast<const uint4*>(&qs[r0 + i][d]);
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
      ps[r0 + i][lane] = round_bf16(p);
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();

    for (int c = 0; c < BK; ++c) {
      float vv[DL];
#pragma unroll
      for (int j = 0; j < DL; ++j) vv[j] = bf16_to_float(vs[c][lane + 32 * j]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = ps[r0 + i][c];
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[i][j] += p * vv[j];
      }
    }
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

}  // extern "C"
