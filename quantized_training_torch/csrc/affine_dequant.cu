// Streaming dequant of group-affine packed weights to plane-major bf16:
//   out[p*kp + r, n] = bf16((c[r*PER + p, n] - zp[g, n]) * sf[g, n]),
//   g = (r*PER + p) / group = r / (group/PER),
// codes (kp, N) int32 words (PER = 32/NBITS fields, each the centered code
// c - 2^(NBITS-1) as an NBITS-wide two's-complement field), sf/zp (K/group,
// N) f32, out (K, N) bf16 with K = kp*PER.  Bit for bit the plain
// ops/affine_storage.py:_dequant_planes rounded once to bf16, rows permuted
// plane-major; x permuted by _plane_major_x times out is the product.
//
// Replaces quantized_training_tpu/ops/pallas/affine_storage.py:185
// (_dequant_kernel, reached through dequant_planes_tpu), which on the TPU
// fed affine_matmul's fallback for K the block picker cannot tile.  On the
// H100 the GEMM takes any K itself, so this stream is off the model path.
//
// What bounds it on an H100: bytes, K*N*NBITS/8 of codes + the qparams in,
// 2*K*N bytes of bf16 out, over 3.35 TB/s.  One thread per word: it reads
// the word and its group's scale and zero point (neighbouring threads on
// neighbouring columns, so every load and store is coalesced) and writes
// PER bf16 values, one into each plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return static_cast<uint16_t>(u >> 16);
  u += 0x7fffu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

template <int NBITS>
__global__ void dequant_planes(const int32_t* __restrict__ codes,
                               const float* __restrict__ sf,
                               const float* __restrict__ zp,
                               uint16_t* __restrict__ out, int kp, int N,
                               int gwords) {
  constexpr int PER = 32 / NBITS;
  constexpr int MID = 1 << (NBITS - 1);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (n >= N) return;
  const uint32_t word = static_cast<uint32_t>(codes[static_cast<size_t>(r) * N + n]);
  const size_t q = static_cast<size_t>(r / gwords) * N + n;
  const float s = sf[q];
  const float z = zp[q];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int32_t c = static_cast<int32_t>(word << (32 - NBITS * (p + 1))) >>
                      (32 - NBITS);
    out[(static_cast<size_t>(p) * kp + r) * N + n] =
        bf16_bits((static_cast<float>(c + MID) - z) * s);
  }
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// codes (K/PER, N) int32, sf/zp (K/group, N) f32, out (K, N) bf16, all
// contiguous; nbits 4 or 2; group % PER == 0, K % group == 0.
int affine_dequant_planes(const void* codes, const void* sf, const void* zp,
                          void* out, int K, int N, int group, int nbits,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nbits != 4 && nbits != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int per = 32 / nbits;
  const int kp = K / per;
  dim3 grid((N + 127) / 128, kp);
  const auto* cp = static_cast<const int32_t*>(codes);
  const auto* sp = static_cast<const float*>(sf);
  const auto* zpp = static_cast<const float*>(zp);
  auto* op = static_cast<uint16_t*>(out);
  if (nbits == 4)
    dequant_planes<4><<<grid, 128, 0, st>>>(cp, sp, zpp, op, kp, N, group / per);
  else
    dequant_planes<2><<<grid, 128, 0, st>>>(cp, sp, zpp, op, kp, N, group / per);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
