// Fused quantize-matmul: y = round(x) @ w with x's rounding (qt_round.cuh)
// done in the A-operand load.
//   x (M, K) bf16 row-major, w (K, N) bf16 row-major, y (M, N) bf16;
//   f32 accumulation, one bf16 rounding of the output.
//
// Replaces quantized_training_tpu/ops/pallas/quantized_matmul.py:31
// (_mm_kernel, reached through quantized_matmul), whose x tiles are rounded
// once on their first use and cached in VMEM across the N sweep.  Here
// every block rounds the A tiles it loads (so each x element is rounded
// once per 128-column block of N), on the CUDA cores, while the tensor
// cores run the product.
//
// What bounds it on an H100: operations, 2*M*N*K over the 989 TFLOP/s bf16
// tensor-core rate, for the shapes of the LLaMA projections (M = tokens in
// the thousands).  Design for this first version: 128x128 output tiles, a
// K step of 32, eight warps each owning 64x32 of the tile through
// mma.sync.m16n8k16 (bf16 in, f32 accumulators in registers); the next K
// step's A and B tiles are loaded into registers while the tensor cores
// work on the current one (A rounded as it is written to shared memory, B
// stored transposed so that each thread's fragment pairs are one 32-bit
// read).  wgmma and TMA are later work.  Any M; K and N multiples of 8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qt_round.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = BK + 8;  // padded shared row (bf16): conflict-free fragments

__device__ __forceinline__ uint32_t round_pair(uint32_t w, const QtFormat& f) {
  const float lo = qt_round<true>(__uint_as_float(w << 16), f);
  const float hi = qt_round<true>(__uint_as_float(w & 0xffff0000u), f);
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
quantized_matmul_kernel(const uint16_t* __restrict__ x,
                        const uint16_t* __restrict__ w,
                        uint16_t* __restrict__ y, int M, int N, int K,
                        QtFormat f) {
  __shared__ __align__(16) uint16_t As[BM][LDS];
  __shared__ __align__(16) uint16_t Bt[BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 64;  // warp's rows in the tile
  const int wn = (warp & 3) * 32;   // warp's columns in the tile
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // each thread moves two 16-byte chunks of A (rows of 32) and of B (rows
  // of 128) per K step
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int ar = c >> 2, ak = (c & 3) * 8;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + ar < M && k0 + ak < K)
        ra[i] = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m0 + ar) * K + k0 + ak);
      const int bk = c >> 4, bn = (c & 15) * 8;
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + bk < K && n0 + bn < N)
        rb[i] = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(k0 + bk) * N + n0 + bn);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int ar = c >> 2, ak = (c & 3) * 8;
      uint4 v = ra[i];
      v.x = round_pair(v.x, f);
      v.y = round_pair(v.y, f);
      v.z = round_pair(v.z, f);
      v.w = round_pair(v.w, f);
      *reinterpret_cast<uint4*>(&As[ar][ak]) = v;
      const int bk = c >> 4, bn = (c & 15) * 8;
      const uint32_t bw[4] = {rb[i].x, rb[i].y, rb[i].z, rb[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Bt[bn + 2 * e][bk] = static_cast<uint16_t>(bw[e] & 0xffffu);
        Bt[bn + 2 * e + 1][bk] = static_cast<uint16_t>(bw[e] >> 16);
      }
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's fragments are read
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t4]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t4]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t4 + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t4 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&Bt[n][kk + 2 * t4]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&Bt[n][kk + 2 * t4 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + j * 8 + 2 * t4;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(m) * N + n) = v;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K), w (K, N), y (M, N): contiguous bf16, 16-byte aligned;
// K % 8 == 0, N % 8 == 0.
int quantized_matmul(const void* x, const void* w, void* y, int M, int N,
                     int K, QtFormat f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quantized_matmul_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<uint16_t*>(y), M, N, K, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
