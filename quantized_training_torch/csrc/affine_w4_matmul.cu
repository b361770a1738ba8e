// W4A16 / W2A16 group-affine storage GEMM:  y = x @ W,
//   W[k, n] = bf16((c[k, n] - zp[g, n]) * sf[g, n]),  g = k / group,
// x (M, K) bf16, y (M, N) bf16, accumulation in f32.
//
// Replaces quantized_training_tpu/ops/pallas/affine_storage.py:255 (_kernel,
// reached through affine_matmul).  Codes are the port's storage layout,
// unchanged: (K/PER, N) int32 words, PER = 32/NBITS (8 for w4, 16 for w2),
// bit field p of word (r, n) holding the centered code c - 2^(NBITS-1) of row
// PER*r + p as an NBITS-wide two's-complement field; sf and zp are
// (K/group, N) f32.  w2x4 (w2 values in the w4 word layout, zero points
// shifted by +6) runs the NBITS = 4 form.
//
// Weight form: each weight is dequantized directly as (c - zp) * sf in f32
// and rounded once to bf16 -- exactly the weight the plain version
// (affine_storage._dequant_planes cast to bf16) multiplies -- so the kernel
// and the plain version differ only in the order of the f32 sums.
//
// What bounds it on an H100: at decode (M <= 8) the bytes of the codes and
// qparams, K*N*NBITS/8 + 8*K*N/group per GEMM, over 3.35 TB/s (qparams are
// 20% of them at w4 and 33% at w2, group 64); at prefill the 2*M*K*N
// operations, on the tensor cores.  Both forms run on the tensor cores;
// w4_decode_plan, exported as affine_w4_matmul_decode_plan, is the one rule
// that picks the form.  Design:
//   * M <= 8 at a group that is a multiple of 16 (w4_gemm_decode, mma.sync):
//     y^T = W^T x^T with mma.sync m16n8k16 (bf16 in, f32 sums), each weight
//     dequantized in registers straight into the A fragment, the M tokens
//     (rows past M zero) on the n8 side.  A lane's fragment rows are k 2t,
//     2t+1, 2t+8, 2t+9 of a 16-deep k step (t = lane % 4): at w4 byte t of
//     each of the column's two words of the step (deq4_pair), at w2
//     nibbles t and t + 4 of its one word (deq2_quad).  A block owns 128
//     output columns; lane group g = lane / 4 owns the columns 32j + 4g ..
//     32j + 4g + 3 (j = 0..3), so one 16-byte shared read of a word row
//     feeds four columns and the eight groups' reads of a row cover 128
//     consecutive bytes, 32 banks, without conflict.  A row g (g + 8) of
//     the warp's mma 2j + h is column 32j + 4g + 2h (+1).
//   * K is split over blocks along whole groups (the grid is (column tiles,
//     splits); w4_decode_plan fills the SMs about twice over, as the byte
//     GEMMs' bsg::decode_plan does, or evens their load), and a
//     block's 8 warps each take a contiguous run of its k steps, so that a
//     warp reads a group's sf and zp once, into registers, where its run
//     enters the group: once a group per block where the runs hold whole
//     groups.  The per-weight path keeps the plain version's arithmetic,
//     bf16((c - zp) * sf) with two f32 roundings, bit for bit: zp is no
//     integer, so it cannot join deq_at's exact magic-number subtraction.
//   * Each warp streams its k steps through a cp.async ring of its own (the
//     step's 16/PER word rows of 512 bytes, the tokens' x over the same k
//     and, where the step opens a group, the group's sf and zp rows),
//     16-byte copies where N % 4 == 0 and the codes and qparams are
//     16-byte aligned, else 4-byte ones, zero past N and M; waited on with
//     __syncwarp, so the warps drift apart and one warp's dequant overlaps
//     another's copies.  The dequant, not the stream, is the work that
//     limits it: about five CUDA-core operations a weight (deq_at's four,
//     its magic numbers a kernel parameter so that the mask and the magic
//     take one LOP3, and half a pack, and at w4 half a shift), amortized
//     over at most 8 tokens, so 2-4x the byte GEMMs' dequant work per
//     byte.
//   * The warps' sums meet in shared memory in warp order, and with more
//     than one split the last block of a column tile adds the splits'
//     partials in split order (bsg::decode_finish, shared with the byte
//     GEMMs): the same bits from every call, no atomics on the output.
//   * Any other M, and M <= 8 at a group that does not hold a whole 16-deep
//     k step (w4 group 8), runs w4_gemm_tc, whose TMA reads the rows past
//     M as zero.
//   * M > 8 (tensor cores, wgmma): the operands swapped, y^T = W^T x^T, so
//     that the weight is dequantized in registers straight into wgmma's A
//     fragment and never makes a bf16 round trip through shared memory; x
//     is the B operand, K-major as it lies in memory, brought in by TMA.
//     A thread's A fragment holds columns col_a and col_a + 8 at k 2q,
//     2q+1, 2q+8, 2q+9 of each 16-deep k step (q = lane % 4), so it reads
//     two words a column a step at w4 (one at w2), takes two (four) fields
//     from each and packs them with cvt.rn.bf16x2; a quad reads the same
//     word and a warp eight adjacent columns, without bank conflicts.
//     About five CUDA-core operations a weight (shift, mask into a float's
//     mantissa, subtract, subtract zp, multiply by sf, half a pack),
//     reused over the block's BM tokens: BM = 256 halves their share of
//     the issue slots against 128.  The A registers are double-buffered
//     and wgmma.wait_group leaves one product in flight, so the dequant of
//     one k step overlaps the product before it.  Each f32 sum is rounded
//     once to bf16 (nearest even) and the tile is staged through shared
//     memory for coalesced rows of y.

#include "byte_storage_gemm.cuh"
#include "tma_pipe.cuh"
#include "wgmma_tile.cuh"

namespace {

using bsg::DC_BK;
using bsg::DC_BN;
using bsg::DC_MAX_SPLITS;
using bsg::DC_MAXM;
using bsg::DC_MIN_BLOCKS;
using bsg::DC_OUT;
using bsg::DC_THREADS;
using bsg::DC_WARPS;
using bsg::DC_XROW;

// ---- M > 8: tensor cores --------------------------------------------------
// y^T = W^T x^T per block of TC_BN output columns x BM tokens: each of two
// consumer warpgroups owns 64 columns and runs wgmma m64nBMk16 with the
// dequantized weight tile (64 columns x 16 k) as the A operand in
// registers and the x tile (BM tokens x 64 k, K-major as x lies in memory,
// 128-byte swizzle) as the B operand in shared memory.  A producer warp
// fills a ring of TC_STAGES stages, each one 64-deep K step: the x tile by
// TMA, and the code words (64/PER word rows x TC_BN columns) and the sf
// and zp rows of their groups by TMA too where the group is a multiple of
// 64, N of 4 and the three 16-byte aligned (one qparam row a step), else by
// its lanes' cp.async (one qparam row per word row): where both can serve,
// the lanes' copies took 9-21% longer (PERF.md).  Full and empty
// mbarriers pass the stages between the producer and the consumers, which
// issue no copies: a first version whose consumers issued the copies ran
// its products at about half the rate (PERF.md).  The consumers' k loop and
// output staging are tma_pipe.cuh's tc_consume and tc_store.
constexpr int TC_STAGES = 4;
constexpr int TC_COL_BYTES = TC_BN * 4; // one smem row of words or qparams

template <int NBITS, int BM, bool ONE_GROUP>
struct TcLayout {
  static constexpr int PER = 32 / NBITS;
  static constexpr int WR = TC_BK / PER;           // word rows per step
  static constexpr int QR = ONE_GROUP ? 1 : WR;    // qparam rows per step
  static constexpr int X_BYTES = BM * ROW_BYTES;   // a multiple of 1024
  static constexpr int W_BYTES = WR * TC_COL_BYTES;
  static constexpr int Q_BYTES = QR * TC_COL_BYTES;  // sf, and again zp
  static constexpr int WQ_BYTES = W_BYTES + 2 * Q_BYTES;
  static constexpr int RING = TC_STAGES * (X_BYTES + WQ_BYTES);
  static constexpr int OUT = BM * TC_OUT_STRIDE * 2;
  static constexpr int BARS = (RING > OUT ? RING : OUT);  // then 2 x STAGES
  static constexpr int SMEM_BYTES = 1024 + BARS + 2 * TC_STAGES * 8;
};

// w = (c - zp) * sf in f32 for the code at bits b.. of t (the plain
// version's weight before its bf16 rounding): the field, its top bit
// flipped (c = centered + 2^(NBITS-1)), is OR'd into the mantissa of
// 2^(23-b), and subtracting 2^(23-b) gives float(c) exactly
__device__ __forceinline__ float deq_at(uint32_t t, uint32_t mask,
                                        uint32_t magic, float base, float z,
                                        float s) {
  const float c = __fsub_rn(__uint_as_float((t & mask) ^ magic), base);
  return __fmul_rn(__fsub_rn(c, z), s);
}

// The magic numbers of deq4_pair (m[0..1]) and deq2_quad (m[0..3]).  A
// LOP3 takes one immediate, so (t & mask) ^ magic is one instruction only
// where the magic is no constant the compiler knows: the decode form takes
// them as a kernel parameter (the 7B qkv decode 0.0327-0.0341 ms against
// 0.0344-0.0346 with two LOP3 a weight, the w2 13B qkv 0.0368 against
// 0.0419; PERF.md); the wgmma form's defaults are immediates.
struct Magic {
  uint32_t m[4];
};
__host__ __device__ constexpr Magic magic_of(int nbits) {
  return nbits == 4 ? Magic{{0x4b000008u, 0x49000080u, 0u, 0u}}
                    : Magic{{0x4b000002u, 0x4a000008u, 0x43020000u,
                             0x42080000u}};
}

// w4: fields 2q and 2q+1 of a word (bits 8q..8q+7), packed lo, hi
__device__ __forceinline__ uint32_t deq4_pair(uint32_t w, int q, float z,
                                              float s,
                                              Magic g = magic_of(4)) {
  const uint32_t t = w >> (8 * q);
  return pack_bf16(deq_at(t, 0xfu, g.m[0], 8388608.f, z, s),
                   deq_at(t, 0xf0u, g.m[1], 524288.f, z, s));
}

// w2: fields 2q, 2q+1 (bits 4q..4q+3) into lo and 2q+8, 2q+9 (bits
// 4q+16..4q+19) into hi
__device__ __forceinline__ void deq2_quad(uint32_t w, int q, float z, float s,
                                          uint32_t& lo, uint32_t& hi,
                                          Magic g = magic_of(2)) {
  const uint32_t t = w >> (4 * q);
  lo = pack_bf16(deq_at(t, 0x3u, g.m[0], 8388608.f, z, s),
                 deq_at(t, 0xcu, g.m[1], 2097152.f, z, s));
  hi = pack_bf16(deq_at(t, 0x30000u, g.m[2], 128.f, z, s),
                 deq_at(t, 0xc0000u, g.m[3], 32.f, z, s));
}

// ROWS rows of TC_BN 4-byte values of a (R, N) matrix, source row row(i)
// (negative: zero) and columns n0.., into consecutive smem rows of
// TC_COL_BYTES, by the 32 lanes of the producer warp; columns at or past N
// are zero.  16-byte copies where vec16 (N % 4 == 0, so that a chunk lies
// wholly inside or outside, and the source 16-byte aligned), else 4-byte
// ones.
template <int ROWS, typename RowFn>
__device__ __forceinline__ void load_cols(uint32_t dst, const void* src,
                                          RowFn row, int n0, int N, int lane,
                                          bool vec16) {
  const char* base = static_cast<const char*>(src);
  if (vec16) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = row(i);
#pragma unroll
      for (int j = 0; j < TC_BN / 128; ++j) {
        const int n = n0 + 4 * lane + 128 * j;
        const bool ok = r >= 0 && n < N;
        cp_async16(dst + i * TC_COL_BYTES + 16 * lane + 512 * j,
                   base + (ok ? (static_cast<size_t>(r) * N + n) * 4 : 0),
                   ok);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = row(i);
#pragma unroll
      for (int j = 0; j < TC_BN / 32; ++j) {
        const int n = n0 + lane + 32 * j;
        const bool ok = r >= 0 && n < N;
        cp_async4(dst + i * TC_COL_BYTES + 4 * (lane + 32 * j),
                  base + (ok ? (static_cast<size_t>(r) * N + n) * 4 : 0), ok);
      }
    }
  }
}

template <int NBITS, int BM, bool ONE_GROUP>
__global__ void __launch_bounds__(TC_THREADS, 1)
w4_gemm_tc(const __grid_constant__ CUtensorMap x_map,
           const __grid_constant__ CUtensorMap w_map,
           const __grid_constant__ CUtensorMap s_map,
           const __grid_constant__ CUtensorMap z_map,
           const int32_t* __restrict__ codes, const float* __restrict__ sf,
           const float* __restrict__ zp, uint16_t* __restrict__ y, int M,
           int K, int N, int group, int tma_wq) {
  using L = TcLayout<NBITS, BM, ONE_GROUP>;
  constexpr int PER = L::PER;
  constexpr int NACC = BM / 2;  // accumulator floats a thread: 64 x BM / 128
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t x_s = (raw + 1023u) & ~1023u;
  const uint32_t wq_s = x_s + TC_STAGES * L::X_BYTES;
  const uint32_t full = x_s + L::BARS;  // TC_STAGES barriers, then empty
  const uint32_t empty = full + TC_STAGES * 8;
  uint8_t* const smem = smem_raw + (x_s - raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * TC_BN;
  const int m0 = blockIdx.y * BM;
  const int nsteps = (K + TC_BK - 1) / TC_BK;

  // full: the TMA copies, and the 32 lanes' cp.async copies unless TMA
  // brings the words and qparams too
  if (tid == 0) tc_init_barriers(full, empty, TC_STAGES, tma_wq ? 1 : 33);
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // the producer: the x tile by TMA (rows past M and k past K read as
    // zero); the words and the group's qparams by TMA too where tma_wq
    // (the group a multiple of 64, N of 4, the three 16-byte aligned), else
    // by the lanes' cp.async, 16 bytes a copy where N % 4 == 0 and the
    // three are aligned
    const bool tma_all = ONE_GROUP && tma_wq;
    const bool vec16 = (N & 3) == 0 &&
                       ((reinterpret_cast<uintptr_t>(codes) |
                         reinterpret_cast<uintptr_t>(sf) |
                         reinterpret_cast<uintptr_t>(zp)) & 15) == 0;
    const int kwords = K / PER;
    const int gwords = group / PER;
    for (int t = 0; t < nsteps; ++t) {
      const int st = t % TC_STAGES;
      if (t >= TC_STAGES) mbar_wait(empty + 8 * st, (t / TC_STAGES - 1) & 1);
      const int k0 = t * TC_BK;
      const int r0 = k0 / PER;
      const int g0 = k0 / group;
      const uint32_t w_s = wq_s + st * L::WQ_BYTES;
      const uint32_t bar = full + 8 * st;
      if (lane == 0) {
        mbar_expect_tx(bar, L::X_BYTES + (tma_all ? L::WQ_BYTES : 0));
        tma_load_2d(x_s + st * L::X_BYTES, &x_map, k0, m0, bar);
        if (tma_all) {
          tma_load_2d(w_s, &w_map, n0, r0, bar);
          tma_load_2d(w_s + L::W_BYTES, &s_map, n0, g0, bar);
          tma_load_2d(w_s + L::W_BYTES + L::Q_BYTES, &z_map, n0, g0, bar);
        }
      }
      if (tma_all) continue;
      load_cols<L::WR>(w_s, codes, [&](int i) {
        return r0 + i < kwords ? r0 + i : -1;
      }, n0, N, lane, vec16);
      auto qrow = [&](int i) {
        if (ONE_GROUP) return g0;
        return r0 + i < kwords ? (r0 + i) / gwords : -1;
      };
      load_cols<L::QR>(w_s + L::W_BYTES, sf, qrow, n0, N, lane, vec16);
      load_cols<L::QR>(w_s + L::W_BYTES + L::Q_BYTES, zp, qrow, n0, N, lane,
                       vec16);
      cp_async_arrive(bar);
    }
    cp_async_wait<0>();
    return;
  }

  const int q = lane & 3;
  // this thread's A rows: output columns col_a and col_a + 8 of the block
  const int col_a = (tid >> 7) * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  // the stage's words of both columns, read before its first dequant; its
  // qparams are read again each k step: held across the stage, the one
  // group's made ptxas serialize the 256-token forms' products (C7512)
  uint32_t wv[L::WR][2];
  const float *ss = nullptr, *zs = nullptr;
  auto load = [&](int st) {
    const uint8_t* wq = smem + TC_STAGES * L::X_BYTES + st * L::WQ_BYTES;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(wq);
    ss = reinterpret_cast<const float*>(wq + L::W_BYTES);
    zs = ss + L::QR * TC_BN;
#pragma unroll
    for (int wr = 0; wr < L::WR; ++wr) {
      wv[wr][0] = ws[wr * TC_BN + col_a];
      wv[wr][1] = ws[wr * TC_BN + col_a + 8];
    }
  };
  auto frag = [&](int kk, uint32_t(&a)[4]) {
    if (NBITS == 4) {
      // k 2q, 2q+1 in word row 2kk, k 2q+8, 2q+9 in word row 2kk+1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wr = 2 * kk + h;
        const int qa = ONE_GROUP ? 0 : wr;
#pragma unroll
        for (int ab = 0; ab < 2; ++ab) {
          const int c = qa * TC_BN + col_a + 8 * ab;
          a[2 * h + ab] = deq4_pair(wv[wr][ab], q, zs[c], ss[c]);
        }
      }
    } else {
      // k 2q, 2q+1, 2q+8, 2q+9 in word row kk
      const int qa = ONE_GROUP ? 0 : kk;
#pragma unroll
      for (int ab = 0; ab < 2; ++ab) {
        const int c = qa * TC_BN + col_a + 8 * ab;
        deq2_quad(wv[kk][ab], q, zs[c], ss[c], a[ab], a[2 + ab]);
      }
    }
  };
  float acc[NACC];
  tc_consume<BM, TC_STAGES>(acc, full, empty, x_s, L::X_BYTES, nsteps, lane,
                            load, frag);
  tc_store<BM, 8>(acc, reinterpret_cast<uint16_t*>(smem), y, col_a, q, tid,
                  m0, n0, M, N);
}

template <int NBITS, int BM, bool ONE_GROUP>
cudaError_t launch_tc(const uint16_t* x, const int32_t* codes, const float* sf,
                      const float* zp, uint16_t* y, int M, int K, int N,
                      int group, cudaStream_t s) {
  using L = TcLayout<NBITS, BM, ONE_GROUP>;
  // x (M, K) as BM x 64 boxes in the 128-byte swizzle wgmma reads
  CUtensorMap x_map, w_map, s_map, z_map;
  cudaError_t err = tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x,
                               K, M, 2, TC_BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  // the words, sf and zp as TC_BN-column boxes, where their rows are
  // 16-byte aligned (N % 4 == 0) and a K step reads one group
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) |
                        reinterpret_cast<uintptr_t>(sf) |
                        reinterpret_cast<uintptr_t>(zp)) % 16 == 0;
  const int tma_wq = ONE_GROUP && N % 4 == 0 && aligned;
  w_map = s_map = z_map = x_map;
  if (tma_wq) {
    const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
    if ((err = tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_INT32, codes, N,
                          K / L::PER, 4, TC_BN, L::WR, none)) != cudaSuccess ||
        (err = tensor_map(&s_map, f32, sf, N, K / group, 4, TC_BN, 1,
                          none)) != cudaSuccess ||
        (err = tensor_map(&z_map, f32, zp, N, K / group, 4, TC_BN, 1,
                          none)) != cudaSuccess)
      return err;
  }
  auto kern = w4_gemm_tc<NBITS, BM, ONE_GROUP>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + BM - 1) / BM);
  kern<<<grid, TC_THREADS, L::SMEM_BYTES, s>>>(
      x_map, w_map, s_map, z_map, codes, sf, zp, y, M, K, N, group, tma_wq);
  return cudaGetLastError();
}

template <int NBITS, int BM>
cudaError_t launch_tc_group(const uint16_t* x, const int32_t* codes,
                            const float* sf, const float* zp, uint16_t* y,
                            int M, int K, int N, int group, cudaStream_t s) {
  if (group % TC_BK == 0)
    return launch_tc<NBITS, BM, true>(x, codes, sf, zp, y, M, K, N, group, s);
  return launch_tc<NBITS, BM, false>(x, codes, sf, zp, y, M, K, N, group, s);
}

template <int NBITS>
cudaError_t launch_tc_tile(const uint16_t* x, const int32_t* codes,
                           const float* sf, const float* zp, uint16_t* y,
                           int M, int K, int N, int group, int tile_m,
                           cudaStream_t s) {
  if (tile_m == 64)
    return launch_tc_group<NBITS, 64>(x, codes, sf, zp, y, M, K, N, group, s);
  if (tile_m == 128)
    return launch_tc_group<NBITS, 128>(x, codes, sf, zp, y, M, K, N, group, s);
  if (tile_m == 256)
    return launch_tc_group<NBITS, 256>(x, codes, sf, zp, y, M, K, N, group, s);
  return cudaErrorInvalidValue;
}

// ---- M <= 8: tensor cores (mma.sync) --------------------------------------
// The decode form (the design at the head of the file).  A warp's ring slot
// holds one 16-deep k step: its WR word rows of DC_BN columns (512 bytes
// each, column n0 + 4c + e at byte 16c + 4e), the tokens' x over the same
// k (DC_XROW bytes a token, as in bsg::gemm_decode) and, where the step
// opens a group in the warp's run, that group's sf and zp rows.
template <int NBITS>
struct W4DecodeLayout {
  static constexpr int PER = 32 / NBITS;
  static constexpr int WR = 16 / PER;               // word rows a k step
  static constexpr int ROW = DC_BN * 4;             // a row of words or qparams
  static constexpr int STAGES = NBITS == 4 ? 4 : 6; // about 1 KB of codes a
                                                    // stage either way
  static constexpr int CODES = WR * ROW;
  static constexpr int X = DC_MAXM * DC_XROW;
  static constexpr int STEP = CODES + X + 2 * ROW;  // a multiple of 16
  static constexpr int RING = DC_WARPS * STAGES * STEP;
  static_assert(RING >= DC_WARPS * DC_OUT * 4, "the warps' sums need the ring");
};

// The decode form's launch of an (M, K) x (K, N) product at `group` on a card
// of `sms` SMs: `splits` blocks along K for each DC_BN-column tile (0 where
// the form does not serve it: M > 8, or a group that is not a multiple of
// 16), at most DC_MAX_SPLITS, K / group and one a 128-row share (so that
// each warp has a k step): the most that keep every tile's blocks within
// DC_MIN_BLOCKS an SM (bsg::decode_plan's rule), or up to twice that where
// the blocks then spread more evenly over the SMs (the 7B qkv: 4 splits,
// 0.0343 ms against 0.0369 at 2 and 0.0389 at 8; more splits cost more at
// every other decode shape; PERF.md).  Split s takes groups
// [s * G / splits, (s + 1) * G / splits) of the G = K / group.  stage_rows
// is the group: the rows a split is counted in.
bsg::DecodePlan w4_decode_plan(int M, int K, int N, int group, int sms) {
  bsg::DecodePlan p{0, 0, 0, group};
  if (M > DC_MAXM || group < 16 || group % 16 || K < group || K % group ||
      N < 1 || sms < 1)
    return p;
  const int tiles = (N + DC_BN - 1) / DC_BN;
  const int most = std::min({DC_MAX_SPLITS, K / group,
                             std::max(1, K / DC_BK)});
  const int least = std::max(1, std::min(most, DC_MIN_BLOCKS * sms / tiles));
  // up to twice that many where the blocks then spread more evenly over
  // the SMs: the waves of blocks an SM runs, per unit of work
  auto cost = [&](int s) {
    return static_cast<double>((tiles * s + sms - 1) / sms) / s;
  };
  const int top = std::min(most, 2 * least);
  double best = cost(least);
  for (int s = least + 1; s <= top; ++s) best = std::min(best, cost(s));
  p.splits = least;
  while (cost(p.splits) > 1.05 * best) ++p.splits;
  if (p.splits > 1) {
    p.part_floats = p.splits * tiles * DC_OUT;
    p.counters = tiles;
  }
  return p;
}

// One 512-byte smem row: columns n0.. of row r of a (R, N) 4-byte matrix,
// chunk `lane` (columns n0 + 4 lane .. + 3) by this lane, zero at or past N
__device__ __forceinline__ void copy_row(uint32_t dst, const void* src, int r,
                                         int n0, int N, int lane, bool vec16) {
  const char* base = static_cast<const char*>(src);
  const int n = n0 + 4 * lane;
  const size_t at = (static_cast<size_t>(r) * N + n) * 4;
  if (vec16) {
    cp_async16(dst + 16 * lane, n < N ? base + at : base, n < N);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cp_async4(dst + 16 * lane + 4 * e, n + e < N ? base + at + 4 * e : base,
                n + e < N);
  }
}

// k step q (rows 16q..16q+15) into a warp's ring slot, by its 32 lanes: the
// word rows, the tokens' x (zero past M) and, with `opens`, the sf and zp
// rows of the step's group
template <int NBITS>
__device__ __forceinline__ void issue_step(
    uint32_t slot, const uint16_t* __restrict__ x,
    const int32_t* __restrict__ codes, const float* __restrict__ sf,
    const float* __restrict__ zp, int q, bool opens, int n0, int M, int K,
    int N, int group, int lane, bool vec16) {
  using L = W4DecodeLayout<NBITS>;
#pragma unroll
  for (int r = 0; r < L::WR; ++r)
    copy_row(slot + r * L::ROW, codes, q * L::WR + r, n0, N, lane, vec16);
  if (lane < 2 * DC_MAXM) {  // 8 tokens x 2 chunks
    const int tok = lane >> 1, k = 16 * q + 8 * (lane & 1);
    const bool ok = tok < M;
    cp_async16(slot + L::CODES + tok * DC_XROW + 16 * (lane & 1),
               ok ? x + static_cast<size_t>(tok) * K + k : x, ok);
  }
  if (opens) {
    const int g = 16 * q / group;
    copy_row(slot + L::CODES + L::X, sf, g, n0, N, lane, vec16);
    copy_row(slot + L::CODES + L::X + L::ROW, zp, g, n0, N, lane, vec16);
  }
}

template <int NBITS>
__global__ void __launch_bounds__(DC_THREADS, DC_MIN_BLOCKS)
w4_gemm_decode(const uint16_t* __restrict__ x,
               const int32_t* __restrict__ codes, const float* __restrict__ sf,
               const float* __restrict__ zp, uint16_t* __restrict__ y,
               float* __restrict__ part, int* __restrict__ count, int M, int K,
               int N, int group, int splits, Magic magic) {
  using L = W4DecodeLayout<NBITS>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tiles = gridDim.x;
  const int n0 = tile * DC_BN;
  // this block's groups, as k steps, in split order; this warp's
  // contiguous share of them
  const int ngroups = K / group, gsteps = group / 16;
  const int q0 = static_cast<int>(static_cast<long>(split) * ngroups / splits)
                 * gsteps;
  const int q1 = static_cast<int>(static_cast<long>(split + 1) * ngroups /
                                  splits) * gsteps;
  const int qa = q0 + (q1 - q0) * warp / DC_WARPS;
  const int nq = q0 + (q1 - q0) * (warp + 1) / DC_WARPS - qa;
  const uint32_t ring = smem_u32(smem) + warp * L::STAGES * L::STEP;
  const bool vec16 = (N & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(codes) |
                       reinterpret_cast<uintptr_t>(sf) |
                       reinterpret_cast<uintptr_t>(zp)) & 15) == 0;

  // the issue side's step and its place in its group (a step with place 0,
  // or the run's first, opens a group)
  int qi = qa, place = qa % gsteps;
  auto issue = [&](int i) {
    if (i < nq)
      issue_step<NBITS>(ring + (i % L::STAGES) * L::STEP, x, codes, sf, zp,
                        qi, i == 0 || place == 0, n0, M, K, N, group, lane,
                        vec16);
    cp_async_commit();
    ++qi;
    if (++place == gsteps) place = 0;
  };
#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) issue(s);

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  // the sf and zp of the lane's 16 columns 32j + 4g + e, index 4j + e
  float zr[16], sr[16];
  int uplace = qa % gsteps;  // the use side's place in its group

  for (int i = 0; i < nq; ++i) {
    cp_async_wait<L::STAGES - 2>();
    __syncwarp();  // every lane's copies of step i have landed, and every
                   // lane is done with the slot that step i + STAGES - 1
                   // takes
    issue(i + L::STAGES - 1);

    const uint8_t* step =
        smem + warp * L::STAGES * L::STEP + (i % L::STAGES) * L::STEP;
    if (i == 0 || uplace == 0) {
      const uint8_t* qp = step + L::CODES + L::X + 16 * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 s4 = *reinterpret_cast<const float4*>(qp + 128 * j);
        const float4 z4 =
            *reinterpret_cast<const float4*>(qp + L::ROW + 128 * j);
        sr[4 * j] = s4.x, sr[4 * j + 1] = s4.y;
        sr[4 * j + 2] = s4.z, sr[4 * j + 3] = s4.w;
        zr[4 * j] = z4.x, zr[4 * j + 1] = z4.y;
        zr[4 * j + 2] = z4.z, zr[4 * j + 3] = z4.w;
      }
    }
    if (++uplace == gsteps) uplace = 0;
    const uint8_t* xp = step + L::CODES + g * DC_XROW + 4 * t;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xp);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xp + 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // the lane's words of columns 32j + 4g .. + 3, in each word row
      uint4 v[L::WR];
#pragma unroll
      for (int r = 0; r < L::WR; ++r)
        v[r] = *reinterpret_cast<const uint4*>(step + r * L::ROW + 128 * j +
                                               16 * g);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // mma 2j + h: A rows g and g + 8 are the lane's columns ca = 4j + 2h
        // and ca + 1, words e = 2h and 2h + 1 of the chunk
        const int ca = 4 * j + 2 * h, cb = ca + 1;
        uint32_t a0, a1, a2, a3;
        if constexpr (NBITS == 4) {
          // k 2t, 2t+1 in the step's first word, 2t+8, 2t+9 in its second
          a0 = deq4_pair(h ? v[0].z : v[0].x, t, zr[ca], sr[ca], magic);
          a1 = deq4_pair(h ? v[0].w : v[0].y, t, zr[cb], sr[cb], magic);
          a2 = deq4_pair(h ? v[1].z : v[1].x, t, zr[ca], sr[ca], magic);
          a3 = deq4_pair(h ? v[1].w : v[1].y, t, zr[cb], sr[cb], magic);
        } else {
          deq2_quad(h ? v[0].z : v[0].x, t, zr[ca], sr[ca], a0, a2, magic);
          deq2_quad(h ? v[0].w : v[0].y, t, zr[cb], sr[cb], a1, a3, magic);
        }
        mma_bf16(acc[2 * j + h], a0, a1, a2, a3, b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  bsg::decode_finish(
      acc, [&](int m) { return 32 * (m >> 1) + 4 * g + 2 * (m & 1); }, smem,
      y, part, count, tile, split, splits, tiles, n0, M, N);
}

template <int NBITS>
cudaError_t launch_decode(const uint16_t* x, const int32_t* codes,
                          const float* sf, const float* zp, uint16_t* y,
                          float* part, int* count, int M, int K, int N,
                          int group, int splits, cudaStream_t s) {
  auto kern = w4_gemm_decode<NBITS>;
  constexpr int smem = W4DecodeLayout<NBITS>::RING;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + DC_BN - 1) / DC_BN, splits);
  kern<<<grid, DC_THREADS, smem, s>>>(x, codes, sf, zp, y, part, count, M, K,
                                      N, group, splits, magic_of(NBITS));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) bf16, codes (K/PER, N) int32, sf/zp (K/group, N) f32, y (M, N)
// bf16, all contiguous; nbits 4 or 2 (PER = 32/nbits); K % group == 0,
// group % PER == 0, x 16-byte aligned; `sms` the card's SM count.  The
// decode form runs where affine_w4_matmul_decode_plan gives splits > 0,
// w4_gemm_tc elsewhere; where it gives splits > 1, `part` must hold its
// part_floats floats (any contents) and `count` its counters ints, zero
// (each call leaves them zero); the capacities say how much each holds,
// and a launch that would need more is refused.
int affine_w4_matmul(const void* x, const void* codes, const void* sf,
                     const void* zp, void* y, void* part, int part_floats,
                     void* count, int counters, int M, int K, int N,
                     int group, int nbits, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* cp = static_cast<const int32_t*>(codes);
  const auto* sp = static_cast<const float*>(sf);
  const auto* zpp = static_cast<const float*>(zp);
  auto* yp = static_cast<uint16_t*>(y);
  if ((nbits != 4 && nbits != 2) || group <= 0 || K % group ||
      group % (32 / nbits))
    return static_cast<int>(cudaErrorInvalidValue);
  const bsg::DecodePlan plan = w4_decode_plan(M, K, N, group, sms);
  cudaError_t err;
  if (plan.splits) {
    if (plan.splits > 1 &&
        (part == nullptr || count == nullptr ||
         part_floats < plan.part_floats || counters < plan.counters))
      return static_cast<int>(cudaErrorInvalidValue);
    auto* pp = static_cast<float*>(part);
    auto* cnt = static_cast<int*>(count);
    err = nbits == 4 ? launch_decode<4>(xp, cp, sp, zpp, yp, pp, cnt, M, K, N,
                                        group, plan.splits, s)
                     : launch_decode<2>(xp, cp, sp, zpp, yp, pp, cnt, M, K, N,
                                        group, plan.splits, s);
    return static_cast<int>(err);
  }
  const int tile_m = pick_tile_m(M, N, TC_BN, sms);
  err = nbits == 4
            ? launch_tc_tile<4>(xp, cp, sp, zpp, yp, M, K, N, group, tile_m, s)
            : launch_tc_tile<2>(xp, cp, sp, zpp, yp, M, K, N, group, tile_m, s);
  return static_cast<int>(err);
}

// w4_decode_plan of that call: plan[0..3] = splits (0: w4_gemm_tc),
// workspace floats, counters, rows a split is counted in (the group).
void affine_w4_matmul_decode_plan(int M, int K, int N, int group, int sms,
                                  int* plan) {
  const bsg::DecodePlan p = w4_decode_plan(M, K, N, group, sms);
  plan[0] = p.splits;
  plan[1] = p.part_floats;
  plan[2] = p.counters;
  plan[3] = p.stage_rows;
}

}  // extern "C"
