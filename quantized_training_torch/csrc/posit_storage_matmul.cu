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
// a weight costs one table read.  In both forms the table holds one copy a
// lane (32 KB), so that a warp's 32 lookups of random codes hit 32 banks;
// a weight costs a byte permute, an address and the read, and a byte
// permute packs the bf16 halves of two table words into an A register
// (every posit8 value is exact in bf16, so the f32 word's low half is 0).

#include "byte_storage_gemm.cuh"
#include "qt_round.cuh"

namespace {

struct PositDecoder {
  static constexpr bool kTable = true;
  static constexpr bool kScales = false;
  int nbits;
  int es;
  __host__ __device__ bool decode_ok() const { return true; }
  __device__ __forceinline__ float entry(int i) const {
    return qt_posit_decode(i, nbits, es);
  }

  // this lane's copy of the table, as a shared-memory address
  __device__ __forceinline__ uint32_t aux(uint32_t lane_table) const {
    return lane_table;
  }
  // the table word of byte b of a code word: entry e at lane_table + 128 e
  static __device__ __forceinline__ uint32_t look(uint32_t word, int b,
                                                  uint32_t lane_table) {
    const uint32_t e = __byte_perm(word, 0u, 0x4440u | b);
    uint32_t v;
    asm("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(lane_table + (e << 7)));
    return v;
  }
  // the A registers of gemm_decode's mma j, as MxDecoder::pairs
  __device__ __forceinline__ void pairs(uint32_t w0, uint32_t w1, uint32_t w2,
                                        uint32_t w3, int b, uint32_t,
                                        uint32_t, uint32_t lane_table,
                                        uint32_t& a0, uint32_t& a1,
                                        uint32_t& a2, uint32_t& a3) const {
    const uint32_t t = lane_table;
    a0 = __byte_perm(look(w0, b, t), look(w1, b, t), 0x7632u);
    a1 = __byte_perm(look(w0, b + 1, t), look(w1, b + 1, t), 0x7632u);
    a2 = __byte_perm(look(w2, b, t), look(w3, b, t), 0x7632u);
    a3 = __byte_perm(look(w2, b + 1, t), look(w3, b + 1, t), 0x7632u);
  }
  // the A registers of gemm_tc's k step, as MxDecoder::tc_frag (no scales)
  __device__ __forceinline__ void tc_frag(uint32_t w01, uint32_t w89,
                                          uint32_t, uint32_t, uint32_t,
                                          uint32_t, uint32_t lane_table,
                                          uint32_t (&a)[4]) const {
    const uint32_t t = lane_table;
    a[0] = __byte_perm(look(w01, 0, t), look(w01, 2, t), 0x7632u);
    a[1] = __byte_perm(look(w01, 1, t), look(w01, 3, t), 0x7632u);
    a[2] = __byte_perm(look(w89, 0, t), look(w89, 2, t), 0x7632u);
    a[3] = __byte_perm(look(w89, 1, t), look(w89, 3, t), 0x7632u);
  }
};

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) bf16 16-byte aligned, codes (K, N) int8, y (M, N) bf16, all
// contiguous; nbits == 8, es in 0..2, K % 8 == 0; `sms` the card's SM
// count.  The workspace `part` (part_floats floats) and the zeroed counters
// `count` (counters ints) are those of bsg::launch, as
// posit_storage_matmul_decode_plan sizes them.
int posit_storage_matmul(const void* x, const void* codes, void* y, void* part,
                         int part_floats, void* count, int counters, int M,
                         int K, int N, int nbits, int es, int sms,
                         void* stream) {
  if (nbits != 8 || es < 0 || es > 2) return static_cast<int>(cudaErrorInvalidValue);
  const PositDecoder dec{nbits, es};
  return bsg::launch(x, codes, dec, y, part, part_floats, count, counters, M,
                     K, N, sms, static_cast<cudaStream_t>(stream));
}

// bsg::decode_plan of that call: plan[0..3] = splits (0: gemm_tc),
// workspace floats, counters, rows a stage.
void posit_storage_matmul_decode_plan(int M, int K, int N, int es, int sms,
                                      int* plan) {
  const PositDecoder dec{8, es};
  const bsg::DecodePlan p = bsg::decode_plan(dec, M, K, N, sms);
  plan[0] = p.splits;
  plan[1] = p.part_floats;
  plan[2] = p.counters;
  plan[3] = p.stage_rows;
}

}  // extern "C"
