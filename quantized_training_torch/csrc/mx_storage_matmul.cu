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
// At M <= 8 (block sizes a multiple of 8) the scale rows stream through the
// ring beside the codes and each 8-row half of a k step reads one (a block
// size that is a multiple of 16 streams one row a step); a weight costs a byte
// permute and one FMA: the code, its sign bit flipped, goes into bits 8-15
// of the mantissa of 2^15, so the float is 32768 + 128 + code, and
// fma(that, s, -32896 s) is code * s exactly (a 16-bit integer times the
// 8-bit significand of s, and 32896 s, are exact in f32); cvt.rn.bf16x2
// rounds two weights into an A register.  At M > 8 (gemm_tc) the same
// weight, with the scale rows streamed through the stage ring: one row a
// 64-row stage (by TMA) where the block size is a multiple of 64, else one
// row a k row (the scale row of each k row, copied by the producer's
// lanes; a lane reads both of its columns' scales in one word).  gemm_tc
// also serves M <= 8 at block sizes that are not a multiple of 8.

#include "byte_storage_gemm.cuh"

namespace {

struct MxDecoder {
  static constexpr bool kTable = false;
  static constexpr bool kScales = true;
  const uint16_t* scales;
  int bs;
  // each 8-row half of a k step reads one scale row
  __host__ __device__ bool decode_ok() const { return bs % 8 == 0; }

  // 0x47000000, the bits of the float 2^15, passed as a parameter: an
  // immediate would take the byte permute's immediate slot and push its
  // selector into a register
  uint32_t magic;
  __device__ __forceinline__ uint32_t aux(uint32_t) const { return magic; }

  // code * s in f32, exactly, for byte b of a code word whose sign bits are
  // flipped
  static __device__ __forceinline__ float weight(uint32_t flipped, int b,
                                                 float s, float c,
                                                 uint32_t magic) {
    const uint32_t m = __byte_perm(flipped, magic, 0x7404u | (b << 4));
    return __fmaf_rn(__uint_as_float(m), s, c);  // m = 0x4700uu00
  }
  // the A registers of gemm_decode's mma j: bytes b (column 2j) and b + 1
  // (column 2j + 1) of code rows k 2t, 2t+1 (w0, w1) and 2t+8, 2t+9 (w2,
  // w3); s01 holds the two columns' bf16 scales of rows 0-7 of the k step,
  // s89 those of rows 8-15 (the same word where a block spans the step)
  __device__ __forceinline__ void pairs(uint32_t w0, uint32_t w1, uint32_t w2,
                                        uint32_t w3, int b, uint32_t s01,
                                        uint32_t s89, uint32_t magic,
                                        uint32_t& a0, uint32_t& a1,
                                        uint32_t& a2, uint32_t& a3) const {
    const float s_lo = __uint_as_float(s01 << 16);
    const float s_hi = __uint_as_float(s01 & 0xffff0000u);
    const float c_lo = s_lo * -32896.f, c_hi = s_hi * -32896.f;
    const float s8_lo = __uint_as_float(s89 << 16);
    const float s8_hi = __uint_as_float(s89 & 0xffff0000u);
    const float c8_lo = s8_lo * -32896.f, c8_hi = s8_hi * -32896.f;
    w0 ^= 0x80808080u;
    w1 ^= 0x80808080u;
    w2 ^= 0x80808080u;
    w3 ^= 0x80808080u;
    a0 = pack_bf16(weight(w0, b, s_lo, c_lo, magic),
                   weight(w1, b, s_lo, c_lo, magic));
    a1 = pack_bf16(weight(w0, b + 1, s_hi, c_hi, magic),
                   weight(w1, b + 1, s_hi, c_hi, magic));
    a2 = pack_bf16(weight(w2, b, s8_lo, c8_lo, magic),
                   weight(w3, b, s8_lo, c8_lo, magic));
    a3 = pack_bf16(weight(w2, b + 1, s8_hi, c8_hi, magic),
                   weight(w3, b + 1, s8_hi, c8_hi, magic));
  }

  // code * s of byte b of a flipped code word, s the low (hi == false) or
  // high bf16 of a scale word
  static __device__ __forceinline__ float scaled(uint32_t flipped, int b,
                                                 uint32_t s_word, bool hi,
                                                 uint32_t magic) {
    const float s = __uint_as_float(hi ? s_word & 0xffff0000u : s_word << 16);
    return weight(flipped, b, s, s * -32896.f, magic);
  }
  // the A registers of gemm_tc's k step: w01 holds the codes of the lane's
  // columns col, col + 1 at k row 2q (bytes 0, 1) and 2q + 1 (bytes 2, 3),
  // w89 those of rows 2q + 8 and 2q + 9; s_r the two columns' bf16 scales
  // of row r (the same word four times where one row serves the stage)
  __device__ __forceinline__ void tc_frag(uint32_t w01, uint32_t w89,
                                          uint32_t s0, uint32_t s1,
                                          uint32_t s8, uint32_t s9,
                                          uint32_t magic,
                                          uint32_t (&a)[4]) const {
    w01 ^= 0x80808080u;
    w89 ^= 0x80808080u;
    a[0] = pack_bf16(scaled(w01, 0, s0, false, magic),
                     scaled(w01, 2, s1, false, magic));
    a[1] = pack_bf16(scaled(w01, 1, s0, true, magic),
                     scaled(w01, 3, s1, true, magic));
    a[2] = pack_bf16(scaled(w89, 0, s8, false, magic),
                     scaled(w89, 2, s9, false, magic));
    a[3] = pack_bf16(scaled(w89, 1, s8, true, magic),
                     scaled(w89, 3, s9, true, magic));
  }
};

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) bf16 16-byte aligned, codes (K, N) int8, scales (K/bs, N) bf16,
// y (M, N) bf16, all contiguous; K % bs == 0, K % 8 == 0; `sms` the card's
// SM count.  The workspace `part` (part_floats floats) and the zeroed
// counters `count` (counters ints) are those of bsg::launch, as
// mx_storage_matmul_decode_plan sizes them.
int mx_storage_matmul(const void* x, const void* codes, const void* scales,
                      void* y, void* part, int part_floats, void* count,
                      int counters, int M, int K, int N, int bs, int sms,
                      void* stream) {
  if (bs <= 0 || K % bs) return static_cast<int>(cudaErrorInvalidValue);
  const MxDecoder dec{static_cast<const uint16_t*>(scales), bs,
                      0x47000000u};
  return bsg::launch(x, codes, dec, y, part, part_floats, count, counters, M,
                     K, N, sms, static_cast<cudaStream_t>(stream));
}

// bsg::decode_plan of that call: plan[0..3] = splits (0: gemm_tc),
// workspace floats, counters, rows a stage.
void mx_storage_matmul_decode_plan(int M, int K, int N, int bs, int sms,
                                   int* plan) {
  const MxDecoder dec{nullptr, bs, 0u};
  const bsg::DecodePlan p = bsg::decode_plan(dec, M, K, N, sms);
  plan[0] = p.splits;
  plan[1] = p.part_floats;
  plan[2] = p.counters;
  plan[3] = p.stage_rows;
}

}  // extern "C"
