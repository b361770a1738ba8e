// GEMM over weights stored one byte per element:  y = x @ W,
//   W[k, n] = DEC(codes[k, n], k, n), a bf16 value computed in f32,
// x (M, K) bf16, codes (K, N) int8, y (M, N) bf16, accumulation in f32.
// Shared by mx_storage_matmul.cu (DEC = code * block scale, rounded to bf16)
// and posit_storage_matmul.cu (DEC = a 256-entry decode table).
//
// What bounds it on an H100: at decode (M <= 8) the K*N code bytes (plus the
// scales) over 3.35 TB/s; at prefill the 2*M*K*N operations.  The design is
// csrc/affine_w4_matmul.cu's, with a byte per weight in place of a field of
// a word (no tensor cores yet):
//   * M <= 8: one thread per output column, eight warps splitting K in
//     chunks of 16 rows, each warp loading a chunk's codes for 32 adjacent
//     columns (32-byte coalesced rows) before using them; x rows through the
//     L1 cache; the partial sums meet in shared memory.
//   * M > 8: a 64x64 output tile per block, K walked 64 rows at a time; the
//     code tile is decoded once into shared memory and reused by all 64
//     rows; each thread accumulates a 4x4 tile with CUDA-core FMAs.
// A decoder is a struct with `setup(float* table)`, run by every block
// before the first decode (it may fill the 256-float shared table and must
// end in __syncthreads if it does), and `float operator()(int code, int k,
// int n, const float* table)`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bsg {

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  return static_cast<uint16_t>(__float_as_uint(round_bf16(v)) >> 16);
}

// ---- M <= 8 ---------------------------------------------------------------
constexpr int SM_MAXM = 8;
constexpr int SM_WARPS = 8;
constexpr int SM_BN = 32;
constexpr int SM_CHUNK = 16;  // K rows loaded before use, per lane

template <class Dec>
__global__ void __launch_bounds__(SM_WARPS * 32)
gemm_small_m(const uint16_t* __restrict__ x, const int8_t* __restrict__ codes,
             Dec dec, uint16_t* __restrict__ y, int M, int K, int N) {
  __shared__ float table[256];
  __shared__ float red[SM_WARPS][SM_MAXM][SM_BN];
  dec.setup(table);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * SM_BN + lane;

  float acc[SM_MAXM];
#pragma unroll
  for (int m = 0; m < SM_MAXM; ++m) acc[m] = 0.f;

  if (n < N) {
    for (int k0 = warp * SM_CHUNK; k0 < K; k0 += SM_WARPS * SM_CHUNK) {
      const int nk = min(SM_CHUNK, K - k0);  // a multiple of 8
      int c[SM_CHUNK];
#pragma unroll
      for (int i = 0; i < SM_CHUNK; ++i)
        c[i] = i < nk ? codes[static_cast<size_t>(k0 + i) * N + n] : 0;
      float wv[SM_CHUNK];
#pragma unroll
      for (int i = 0; i < SM_CHUNK; ++i) wv[i] = i < nk ? dec(c[i], k0 + i, n, table) : 0.f;
#pragma unroll
      for (int m = 0; m < SM_MAXM; ++m) {
        if (m >= M) break;
        float a = acc[m];
#pragma unroll
        for (int h = 0; h < SM_CHUNK / 8; ++h) {
          if (8 * h >= nk) break;
          const uint4 xv = *reinterpret_cast<const uint4*>(
              x + static_cast<size_t>(m) * K + k0 + 8 * h);
          const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            a += bf16_bits_to_float(xw[q] & 0xffffu) * wv[8 * h + 2 * q];
            a += bf16_bits_to_float(xw[q] >> 16) * wv[8 * h + 2 * q + 1];
          }
        }
        acc[m] = a;
      }
    }
  }

#pragma unroll
  for (int m = 0; m < SM_MAXM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  // SM_WARPS == SM_MAXM: warp index doubles as the output row
  const int m = warp;
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < SM_WARPS; ++w) sum += red[w][m][lane];
  if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = float_to_bf16_bits(sum);
}

// ---- M > 8 ----------------------------------------------------------------
constexpr int TB_M = 64;
constexpr int TB_N = 64;
constexpr int TB_K = 64;
constexpr int TB_THREADS = 256;

template <class Dec>
__global__ void __launch_bounds__(TB_THREADS)
gemm_tiled(const uint16_t* __restrict__ x, const int8_t* __restrict__ codes,
           Dec dec, uint16_t* __restrict__ y, int M, int K, int N) {
  __shared__ float table[256];
  __shared__ __align__(16) float xs[TB_K][TB_M];  // x tile, k-major
  __shared__ __align__(16) float ws[TB_K][TB_N];  // decoded weights
  dec.setup(table);

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns 4*tx .. 4*tx+3
  const int ty = tid / 16;  // output rows 4*ty .. 4*ty+3
  const int m0 = blockIdx.y * TB_M;
  const int n0 = blockIdx.x * TB_N;

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
          xv = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k);
        const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xs[kc + 8 * h + 2 * q][row] = bf16_bits_to_float(xw[q] & 0xffffu);
          xs[kc + 8 * h + 2 * q + 1][row] = bf16_bits_to_float(xw[q] >> 16);
        }
      }
    }
    // code tile: 64 rows x 64 columns, 16 codes per thread
    {
      const int kk = tid / 4;
      const int c0 = (tid % 4) * 16;
      const int k = k0 + kk;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + c0 + j;
        ws[kk][c0 + j] = (k < K && n < N)
            ? dec(codes[static_cast<size_t>(k) * N + n], k, n, table) : 0.f;
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

// x (M, K) bf16 16-byte aligned, codes (K, N) int8, y (M, N) bf16, all
// contiguous, K % 8 == 0.
template <class Dec>
int launch(const void* x, const void* codes, const Dec& dec, void* y, int M,
           int K, int N, cudaStream_t s) {
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  auto* yp = static_cast<uint16_t*>(y);
  if (K % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= SM_MAXM) {
    dim3 grid((N + SM_BN - 1) / SM_BN);
    gemm_small_m<Dec><<<grid, SM_WARPS * 32, 0, s>>>(xp, cp, dec, yp, M, K, N);
  } else {
    dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    gemm_tiled<Dec><<<grid, TB_THREADS, 0, s>>>(xp, cp, dec, yp, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bsg
