// Elementwise direct rounding of a contiguous tensor (bf16 or f32 in, the
// same dtype out) to one of the formats of qt_round.cuh.
//
// Replaces quantized_training_tpu/ops/pallas/quantize_elemwise.py:30
// (_kernel, reached through pallas_quantize).  The TPU kernel tiles a
// flattened (rows, 1024) view and falls back to XLA when the size does not
// tile; here any size is taken and the ragged tail is masked.
//
// Every kind of qt_round.cuh: posit, fp8, fpN, int, the NormalFloat
// codebooks (the search compares in the input's dtype, so bf16 and f32
// inputs take separate instantiations) and the native bf16 / f16 casts.
//
// What bounds it on an H100: bytes, one read and one write of the tensor at
// 3.35 TB/s; the ~20 integer operations per element of the posit rounding,
// and the ~100 of a 16-entry codebook search (subtract, round to bf16,
// compare and select per entry, unrolled over the codebook held in the
// parameter bank), stay near or below that on 132 SMs.  Each thread moves 16 bytes per load and store
// (8 bf16 or 4 f32 values) in a grid-stride loop; a tensor whose pointers
// are not 16-byte aligned takes the scalar loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qt_round.cuh"

namespace {

constexpr int THREADS = 256;

template <bool BF16, bool VEC>
__global__ void __launch_bounds__(THREADS)
quantize_elemwise_kernel(const void* __restrict__ xv, void* __restrict__ yv,
                         int64_t n, QtFormat f) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (BF16) {
    const auto* x = static_cast<const uint16_t*>(xv);
    auto* y = static_cast<uint16_t*>(yv);
    int64_t start = 0;
    if (VEC) {
      const int64_t nv = n / 8;
      for (int64_t i = tid; i < nv; i += stride) {
        uint4 w = reinterpret_cast<const uint4*>(x)[i];
        uint32_t* p = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = qt_round<true>(__uint_as_float(p[e] << 16), f);
          const float hi = qt_round<true>(__uint_as_float(p[e] & 0xffff0000u), f);
          p[e] = (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
        }
        reinterpret_cast<uint4*>(y)[i] = w;
      }
      start = nv * 8;
    }
    for (int64_t i = start + tid; i < n; i += stride) {
      const float v = qt_round<true>(__uint_as_float(static_cast<uint32_t>(x[i]) << 16), f);
      y[i] = static_cast<uint16_t>(__float_as_uint(v) >> 16);
    }
  } else {
    const auto* x = static_cast<const float*>(xv);
    auto* y = static_cast<float*>(yv);
    int64_t start = 0;
    if (VEC) {
      const int64_t nv = n / 4;
      for (int64_t i = tid; i < nv; i += stride) {
        float4 w = reinterpret_cast<const float4*>(x)[i];
        w.x = qt_round<false>(w.x, f);
        w.y = qt_round<false>(w.y, f);
        w.z = qt_round<false>(w.z, f);
        w.w = qt_round<false>(w.w, f);
        reinterpret_cast<float4*>(y)[i] = w;
      }
      start = nv * 4;
    }
    for (int64_t i = start + tid; i < n; i += stride) y[i] = qt_round<false>(x[i], f);
  }
}

template <bool BF16>
void launch(const void* x, void* y, int64_t n, QtFormat f, bool vec,
            cudaStream_t st) {
  const int64_t per_thread = vec ? (BF16 ? 8 : 4) : 1;
  int64_t blocks = (n / per_thread + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : (blocks > 132 * 16 ? 132 * 16 : blocks);
  if (vec)
    quantize_elemwise_kernel<BF16, true><<<static_cast<int>(blocks), THREADS, 0, st>>>(x, y, n, f);
  else
    quantize_elemwise_kernel<BF16, false><<<static_cast<int>(blocks), THREADS, 0, st>>>(x, y, n, f);
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y: n contiguous elements each, bf16 (is_bf16 = 1) or f32, not aliased.
int quantize_elemwise(const void* x, void* y, long long n, int is_bf16,
                      QtFormat f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (n > 0) {
    if (is_bf16)
      launch<true>(x, y, n, f, vec, st);
    else
      launch<false>(x, y, n, f, vec, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
