// W4A16 group-affine storage GEMM:  y = x @ W,
//   W[k, n] = bf16((c[k, n] - zp[g, n]) * sf[g, n]),  g = k / group,
// x (M, K) bf16, y (M, N) bf16, accumulation in f32.
//
// Replaces quantized_training_tpu/ops/pallas/affine_storage.py:255 (_kernel,
// reached through affine_matmul).  Codes are the port's storage layout,
// unchanged: (K/8, N) int32 words, bit field p of word (r, n) holding the
// centered code c - 8 of row 8r + p as a 4-bit two's-complement field; sf and
// zp are (K/group, N) f32.
//
// Weight form: each weight is dequantized directly as (c - zp) * sf in f32
// and rounded once to bf16 -- exactly the weight the plain version
// (affine_storage._dequant_planes cast to bf16) multiplies -- so the kernel
// and the plain version differ only in the order of the f32 sums.
//
// What bounds it on an H100: at decode (M <= 8) the bytes of the codes and
// qparams (K*N/2 + K*N/8 per GEMM) over 3.35 TB/s; at prefill the
// 2*M*K*N operations.  Design for this first version (no tensor cores yet):
//   * M <= 8: one thread per output column, eight warps per block splitting
//     K by groups, each warp loading a group's words for 32 adjacent columns
//     (128-byte coalesced rows) before using them, so eight loads are in
//     flight per warp; x rows are read through the L1 cache; the eight
//     partial sums meet in shared memory.  No 8x padding of the rows.
//   * M > 8: a 64x64 output tile per block, K walked 64 rows (8 word rows)
//     at a time; the word tile is unpacked and dequantized once into shared
//     memory and reused by all 64 rows; each thread accumulates a 4x4 tile
//     with CUDA-core FMAs.
// Words are unpacked by a left shift on the unsigned word and an arithmetic
// right shift of its int32 reinterpretation (sign extension without any
// undefined shift of a negative value).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  // round to nearest even, as __float2bfloat16 does; NaN is kept NaN
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  uint32_t u = __float_as_uint(round_bf16(v));
  return static_cast<uint16_t>(u >> 16);
}

__device__ __forceinline__ float dequant(uint32_t word, int p, float zp,
                                         float sf) {
  int32_t c = static_cast<int32_t>(word << (28 - 4 * p)) >> 28;  // c - 8
  return round_bf16((static_cast<float>(c + 8) - zp) * sf);
}

// ---- M <= 8 ---------------------------------------------------------------
constexpr int SM_MAXM = 8;
constexpr int SM_WARPS = 8;
constexpr int SM_BN = 32;
constexpr int SM_CHUNK = 8;  // words loaded before use, per lane

__global__ void __launch_bounds__(SM_WARPS * 32)
w4_gemm_small_m(const uint16_t* __restrict__ x,
                const int32_t* __restrict__ codes,
                const float* __restrict__ sf, const float* __restrict__ zp,
                uint16_t* __restrict__ y, int M, int K, int N, int group) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * SM_BN + lane;
  const int ngroups = K / group;
  const int gwords = group / 8;

  float acc[SM_MAXM];
#pragma unroll
  for (int m = 0; m < SM_MAXM; ++m) acc[m] = 0.f;

  if (n < N) {
    for (int g = warp; g < ngroups; g += SM_WARPS) {
      const float s = sf[static_cast<size_t>(g) * N + n];
      const float z = zp[static_cast<size_t>(g) * N + n];
      for (int w0 = 0; w0 < gwords; w0 += SM_CHUNK) {
        const int nw = min(SM_CHUNK, gwords - w0);
        const int r0 = g * gwords + w0;  // first word row of this chunk
        uint32_t words[SM_CHUNK];
#pragma unroll
        for (int w = 0; w < SM_CHUNK; ++w)
          words[w] = w < nw ? static_cast<uint32_t>(
                                  codes[static_cast<size_t>(r0 + w) * N + n])
                            : 0u;
#pragma unroll
        for (int w = 0; w < SM_CHUNK; ++w) {
          if (w >= nw) break;
          float wv[8];
#pragma unroll
          for (int p = 0; p < 8; ++p) wv[p] = dequant(words[w], p, z, s);
          const int k0 = (r0 + w) * 8;
#pragma unroll
          for (int m = 0; m < SM_MAXM; ++m) {
            if (m >= M) break;
            const uint4 xv = *reinterpret_cast<const uint4*>(
                x + static_cast<size_t>(m) * K + k0);
            const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
            float a = acc[m];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              a += bf16_bits_to_float(xw[q] & 0xffffu) * wv[2 * q];
              a += bf16_bits_to_float(xw[q] >> 16) * wv[2 * q + 1];
            }
            acc[m] = a;
          }
        }
      }
    }
  }

  __shared__ float red[SM_WARPS][SM_MAXM][SM_BN];
#pragma unroll
  for (int m = 0; m < SM_MAXM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  // SM_WARPS == SM_MAXM: warp index doubles as the output row
  const int m = warp;
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < SM_WARPS; ++w) sum += red[w][m][lane];
  if (m < M && n < N)
    y[static_cast<size_t>(m) * N + n] = float_to_bf16_bits(sum);
}

// ---- M > 8 ----------------------------------------------------------------
constexpr int TB_M = 64;
constexpr int TB_N = 64;
constexpr int TB_K = 64;  // 8 word rows
constexpr int TB_THREADS = 256;

__global__ void __launch_bounds__(TB_THREADS)
w4_gemm_tiled(const uint16_t* __restrict__ x,
              const int32_t* __restrict__ codes,
              const float* __restrict__ sf, const float* __restrict__ zp,
              uint16_t* __restrict__ y, int M, int K, int N, int group) {
  __shared__ __align__(16) float xs[TB_K][TB_M];  // x tile, k-major
  __shared__ __align__(16) float ws[TB_K][TB_N];  // dequantized weights

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns 4*tx .. 4*tx+3
  const int ty = tid / 16;  // output rows 4*ty .. 4*ty+3
  const int m0 = blockIdx.y * TB_M;
  const int n0 = blockIdx.x * TB_N;
  const int kwords = K / 8;
  const int gwords = group / 8;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TB_K) {
    // x tile: 64 rows x 64 k, 16 values per thread (two 16-byte loads)
    {
      const int row = tid / 4;
      const int kc = (tid % 4) * 16;
      const int m = m0 + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + kc + 8 * h;
        uint4 xv = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && k < K)
          xv = *reinterpret_cast<const uint4*>(
              x + static_cast<size_t>(m) * K + k);
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xs[kc + 8 * h + 2 * q][row] = bf16_bits_to_float(xw[q] & 0xffffu);
          xs[kc + 8 * h + 2 * q + 1][row] = bf16_bits_to_float(xw[q] >> 16);
        }
      }
    }
    // word tile: 8 word rows x 64 columns, two words per thread
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = tid + TB_THREADS * h;
      const int wr = idx / TB_N;
      const int col = idx % TB_N;
      const int r = k0 / 8 + wr;
      const int n = n0 + col;
      if (r < kwords && n < N) {
        const uint32_t word = static_cast<uint32_t>(
            codes[static_cast<size_t>(r) * N + n]);
        const int g = r / gwords;
        const float s = sf[static_cast<size_t>(g) * N + n];
        const float z = zp[static_cast<size_t>(g) * N + n];
#pragma unroll
        for (int p = 0; p < 8; ++p) ws[wr * 8 + p][col] = dequant(word, p, z, s);
      } else {
#pragma unroll
        for (int p = 0; p < 8; ++p) ws[wr * 8 + p][col] = 0.f;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < TB_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = float_to_bf16_bits(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) bf16, codes (K/8, N) int32, sf/zp (K/group, N) f32, y (M, N)
// bf16, all contiguous; K % group == 0, group % 8 == 0, x 16-byte aligned.
int affine_w4_matmul(const void* x, const void* codes, const void* sf,
                     const void* zp, void* y, int M, int K, int N, int group,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* cp = static_cast<const int32_t*>(codes);
  const auto* sp = static_cast<const float*>(sf);
  const auto* zpp = static_cast<const float*>(zp);
  auto* yp = static_cast<uint16_t*>(y);
  if (M <= SM_MAXM) {
    dim3 grid((N + SM_BN - 1) / SM_BN);
    w4_gemm_small_m<<<grid, SM_WARPS * 32, 0, s>>>(xp, cp, sp, zpp, yp, M, K,
                                                   N, group);
  } else {
    dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    w4_gemm_tiled<<<grid, TB_THREADS, 0, s>>>(xp, cp, sp, zpp, yp, M, K, N,
                                              group);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
