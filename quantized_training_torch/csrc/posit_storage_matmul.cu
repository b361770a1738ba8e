// Posit8 storage GEMM:  y = x @ W,  W[k, n] = decode_posit(codes[k, n]),
// x (M, K) bf16, codes (K, N) int8 two's-complement posit(8, es) codes, y
// (M, N) bf16, accumulation in f32.  Every posit8 value is exact in bf16,
// so the decoded weight is the posit value itself, bit for bit the plain
// ops/posit_storage.py (numerics/posit.py:decode_posit).
//
// Replaces quantized_training_tpu/ops/pallas/posit_storage.py:39 (_kernel,
// reached through posit_matmul), which decodes each code in VMEM with a
// count-leading-zeros sequence (about 25 vector operations per weight).
//
// What bounds it on an H100, and the design: csrc/byte_storage_gemm.cuh.
// Here each block first computes the 256-entry decode table in shared
// memory from the device decode of csrc/qt_round.cuh (qt_posit_decode), so
// a weight costs one table read.

#include "byte_storage_gemm.cuh"
#include "qt_round.cuh"

namespace {

struct PositDecoder {
  int nbits;
  int es;
  __device__ __forceinline__ void setup(float* table) const {
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
      table[i] = qt_posit_decode(i, nbits, es);
    __syncthreads();
  }
  __device__ __forceinline__ float operator()(int code, int, int,
                                              const float* table) const {
    return table[code & 0xff];
  }
};

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) bf16 16-byte aligned, codes (K, N) int8, y (M, N) bf16, all
// contiguous; nbits == 8, es in 0..2, K % 8 == 0.
int posit_storage_matmul(const void* x, const void* codes, void* y, int M,
                         int K, int N, int nbits, int es, void* stream) {
  if (nbits != 8 || es < 0 || es > 2) return static_cast<int>(cudaErrorInvalidValue);
  const PositDecoder dec{nbits, es};
  return bsg::launch(x, codes, dec, y, M, K, N,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
