// MX-int8 storage GEMM:  y = x @ W,
//   W[k, n] = bf16(codes[k, n] * scales[k / bs, n]),
// x (M, K) bf16, codes (K, N) int8, scales (K/bs, N) bf16, y (M, N) bf16,
// accumulation in f32.  The f32 product of an int8 code and a bf16 scale is
// exact, so the weight is rounded once, bit for bit the plain
// ops/mx_storage.py:mx_dequant.
//
// Replaces quantized_training_tpu/ops/pallas/mx_storage.py:50 (_kernel,
// reached through mx_matmul), which converts a (block_k, block_n) code tile
// and multiplies it by its repeated scales in VMEM before the MXU dot.
//
// What bounds it on an H100, and the design: csrc/byte_storage_gemm.cuh.
// The scale of a code is read beside it (one bf16 per 64 rows of a column,
// served by the L1 cache).

#include "byte_storage_gemm.cuh"

namespace {

struct MxDecoder {
  const uint16_t* scales;
  int N;
  int bs;
  __device__ __forceinline__ void setup(float*) const {}
  __device__ __forceinline__ float operator()(int code, int k, int n,
                                              const float*) const {
    const float s = bsg::bf16_bits_to_float(scales[static_cast<size_t>(k / bs) * N + n]);
    return bsg::round_bf16(static_cast<float>(code) * s);
  }
};

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) bf16 16-byte aligned, codes (K, N) int8, scales (K/bs, N) bf16,
// y (M, N) bf16, all contiguous; K % bs == 0, K % 8 == 0.
int mx_storage_matmul(const void* x, const void* codes, const void* scales,
                      void* y, int M, int K, int N, int bs, void* stream) {
  if (bs <= 0 || K % bs) return static_cast<int>(cudaErrorInvalidValue);
  const MxDecoder dec{static_cast<const uint16_t*>(scales), N, bs};
  return bsg::launch(x, codes, dec, y, M, K, N,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
