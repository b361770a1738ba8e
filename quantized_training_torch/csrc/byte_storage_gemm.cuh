// GEMM over weights stored one byte per element:  y = x @ W,
//   W[k, n] = DEC(codes[k, n], k, n), a bf16 value computed in f32,
// x (M, K) bf16, codes (K, N) int8, y (M, N) bf16, accumulation in f32.
// Shared by mx_storage_matmul.cu (DEC = code * block scale, rounded to bf16)
// and posit_storage_matmul.cu (DEC = a 256-entry decode table).
//
// What bounds it on an H100: at decode (M <= 8) the K*N code bytes (plus the
// scales) over 3.35 TB/s; at prefill the 2*M*K*N operations.
//
// M <= 8 (gemm_decode, tensor cores): y^T = W^T x^T with mma.sync m16n8k16
// (bf16 in, f32 sums), the weight dequantized in registers straight into the
// A fragment and the M tokens (rows past M zero) in the n8 side.
//   * A block owns 128 output columns and a run of 128-row stages of K; each
//     of its eight warps takes every eighth 16-row k step of that run.  A
//     lane of lane group g = lane / 4 owns the columns 16g..16g+15, so one
//     16-byte read of a code row feeds it; A row g (g + 8) of the warp's
//     mma j is column 16g + 2j (+1), so a warp's eight mmas cover its 128
//     columns, and the lane's fragment rows k 2t, 2t+1, 2t+8, 2t+9 (t =
//     lane % 4) are four code rows.  The sums land 16 columns x 2 tokens a
//     lane.
//   * Each warp streams its k steps through a ring of its own (DC_STAGES
//     slots: 16 code rows of 128 bytes, padded to 144 so that the 16-byte
//     reads of a quarter warp hit distinct banks, the tokens' x over them
//     and, for MX, their scale row), filled by its lanes' 16-byte cp.async
//     copies, zero past K, N and M, and waited on with __syncwarp: no
//     block-wide barrier until the end, so the warps drift apart and one
//     warp's dequant overlaps another's copies.  Two blocks an SM keep 64
//     KB of codes in flight.  Operands that are not 16-byte aligned
//     (contiguous views at an odd offset, N % 16 != 0) are copied by plain
//     loads of their own width instead.
//   * Split K: the grid is (column tiles, splits); `decode_plan` picks the
//     splits so that the blocks fill the SMs about twice over in one wave,
//     and says what workspace they need (the libraries export it, so that
//     the wrapper sizes the workspace from the same arithmetic).  The eight warps' sums meet in shared memory
//     in warp order; with splits > 1 each block writes its f32 partial to
//     a workspace, and the last block of a column tile to arrive (a
//     counter, which it resets) adds the splits' partials in split order
//     and rounds each output once to bf16: the same bits from every call,
//     no atomics on the output.
//   * A decoder that serves this form says so (`decode_ok`); MX needs its
//     block size a multiple of 8, so that each 8-row half of a k step reads
//     one scale row (a multiple of 16: the whole step one, and the form is
//     instantiated with kScaleRows 1).
//   * The dequant is the work that competes with the stream: about 3.6
//     (MX) and 3.9 (posit8) instructions a weight, much of it on the
//     integer pipe; the decoders' notes say how each weight is made.
// M > 8 (gemm_tc, tensor cores): y^T = W^T x^T on wgmma m64nBMk16, the
// weight dequantized in registers straight into the A operand and x, the
// K-major B operand, brought by TMA; the structure of kernel 5's
// w4_gemm_tc (affine_w4_matmul.cu) with the byte decoders in place of its
// word unpacking.
//   * A block owns 128 output columns and BM tokens (64, 128 or 256,
//     tma_pipe.cuh:pick_tile_m); two consumer warpgroups of 64 columns and
//     a producer warp pass a ring of 64-deep k stages (as many as fit, at
//     most four) through full and empty mbarriers.  A stage holds the x
//     tile and the code tile (64 rows of 128 bytes), both by TMA in the
//     128-byte swizzle, and for MX the scale rows: one a stage (by TMA)
//     where the block size is a multiple of 64, else one a k row, copied
//     by the producer's lanes.  Codes that are not 16-byte aligned or N %
//     16 != 0 are copied by the lanes' plain loads.
//   * A thread's A rows a and a + 8 are the adjacent output columns col and
//     col + 1, so one 16-bit read of a code row gives both columns' codes
//     and one 32-bit read of a scale row both scales; the swizzle keeps the
//     reads of a warp's four k rows in distinct banks.  The A registers are
//     double-buffered and wgmma.wait_group leaves one product in flight, so
//     one k step's dequant overlaps the product before it.  Each f32 sum is
//     rounded once to bf16 (nearest even) and the tile is staged through
//     shared memory, the column permutation undone, for coalesced rows of
//     y.  It also serves M <= 8 where the decoder refuses the decode form
//     (TMA reads the rows past M as zero).
//
// A decoder is a struct with `kTable` (a 256-entry table of `entry(i)`
// values, one copy a lane), `kScales` (bf16 scale rows `scales`, one per
// `bs` rows of K, to be streamed beside the codes), `bool decode_ok()
// const`, `uint32_t aux(uint32_t lane_table) const` (a register the decode
// keeps: the lane's table address, or a constant), and two functions that
// make A registers from code bytes and the scale words of their rows:
// `pairs(...)` those of one gemm_decode mma, `tc_frag(...)` those of one
// gemm_tc k step (see PositDecoder and MxDecoder).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tma_pipe.cuh"
#include "wgmma_tile.cuh"

namespace bsg {

__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  return static_cast<uint16_t>(__float_as_uint(round_bf16(v)) >> 16);
}

// ---- M <= 8: tensor cores ------------------------------------------------
constexpr int DC_MAXM = 8;
constexpr int DC_WARPS = 8;
constexpr int DC_THREADS = DC_WARPS * 32;
constexpr int DC_BN = 128;                  // output columns per block
constexpr int DC_BK = 16 * DC_WARPS;        // K rows per stage of the split
constexpr int DC_STAGES = 3;                // k steps in each warp's ring
constexpr int DC_CROW = DC_BN + 16;         // smem bytes per code row
constexpr int DC_XROW = 48;                 // smem bytes per token of x
constexpr int DC_OUT = DC_MAXM * DC_BN;     // outputs of a block: 1024
constexpr int DC_TABLE = 256 * 32;          // table words, one copy a lane
constexpr int DC_MIN_BLOCKS = 2;            // blocks an SM (launch bounds)
constexpr int DC_MAX_SPLITS = 16;

// The decode form's launch of an (M, K) x (K, N) product on a card of `sms`
// SMs: `splits` blocks along K for each DC_BN-column tile (0 where the form
// does not serve it), the most that keep every tile's blocks within
// DC_MIN_BLOCKS an SM, at most DC_MAX_SPLITS and one a DC_BK-row stage;
// split s takes stages [s * stages / splits, (s + 1) * stages / splits).
// With splits > 1 the launch needs `part_floats` floats of workspace and
// `counters` zeroed ints.
struct DecodePlan {
  int splits, part_floats, counters, stage_rows;
};

template <class Dec>
DecodePlan decode_plan(const Dec& dec, int M, int K, int N, int sms) {
  DecodePlan p{0, 0, 0, DC_BK};
  if (M > DC_MAXM || K % 8 || N < 1 || sms < 1 || !dec.decode_ok()) return p;
  const int tiles = (N + DC_BN - 1) / DC_BN;
  const int stages = (K + DC_BK - 1) / DC_BK;
  p.splits = std::max(1, std::min({DC_MAX_SPLITS, stages,
                                   DC_MIN_BLOCKS * sms / tiles}));
  if (p.splits > 1) {
    p.part_floats = p.splits * tiles * DC_OUT;
    p.counters = tiles;
  }
  return p;
}

// A warp's ring: DC_STAGES k steps, each 16 code rows, the tokens' x over
// them and (MX) the kScaleRows scale rows of their 8-row halves
template <class Dec, int kScaleRows>
struct DecodeLayout {
  static constexpr int CODES = 16 * DC_CROW;
  static constexpr int X = DC_MAXM * DC_XROW;
  static constexpr int SCALES = Dec::kScales ? 2 * DC_BN * kScaleRows : 0;
  static constexpr int STEP = CODES + X + SCALES;  // a multiple of 16
  static constexpr int RING = DC_WARPS * DC_STAGES * STEP;
  static_assert(RING >= DC_WARPS * DC_OUT * 4, "the warps' sums need the ring");
  static constexpr int SMEM = RING + (Dec::kTable ? DC_TABLE * 4 : 0);
};

// One k step into a warp's ring slot, by its 32 lanes: code rows k0..k0+15
// of columns n0..n0+127, the tokens' x over the same k and (MX) the scale
// row of k0 and, with two scale rows, that of k0 + 8.  Whatever lies past
// K, N or M is zero.
template <class Dec, int kScaleRows>
__device__ __forceinline__ void issue_step(
    uint8_t* step, const uint16_t* __restrict__ x,
    const int8_t* __restrict__ codes, const Dec& dec, int k0, int n0, int M,
    int K, int N, int lane, bool vec_codes, bool vec_scales) {
  using L = DecodeLayout<Dec, kScaleRows>;
  const uint32_t base = smem_u32(step);
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 16 rows x 8 chunks of 16 bytes
    const int q = lane + 32 * i;
    const int r = q >> 3, c = q & 7;
    const int k = k0 + r, n = n0 + 16 * c;
    const int8_t* src = codes + static_cast<size_t>(k) * N + n;
    if (vec_codes) {
      const bool ok = k < K && n < N;
      cp_async16(base + r * DC_CROW + 16 * c, ok ? src : codes, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (k < K && n + b < N)
          w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b]))
                       << (8 * (b & 3));
      *reinterpret_cast<uint4*>(step + r * DC_CROW + 16 * c) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  if (lane < 2 * DC_MAXM) {  // 8 tokens x 2 chunks
    const int tok = lane >> 1, k = k0 + 8 * (lane & 1);
    const bool ok = tok < M && k < K;
    cp_async16(base + L::CODES + tok * DC_XROW + 16 * (lane & 1),
               ok ? x + static_cast<size_t>(tok) * K + k : x, ok);
  } else if constexpr (Dec::kScales) {  // 16 chunks of 8 columns a row
    const int c = lane - 2 * DC_MAXM, n = n0 + 8 * c;
#pragma unroll
    for (int h = 0; h < kScaleRows; ++h) {
      const int k = k0 + 8 * h;  // a half past K (K % 16 == 8) reads none
      const bool ok = n < N && k < K;
      const uint16_t* src =
          dec.scales + static_cast<size_t>(k / dec.bs) * N + n;
      const int off = L::CODES + L::X + 2 * DC_BN * h + 16 * c;
      if (vec_scales) {
        cp_async16(base + off, ok ? src : dec.scales, ok);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (k < K && n + e < N)
            w[e >> 1] |= static_cast<uint32_t>(src[e]) << (16 * (e & 1));
        *reinterpret_cast<uint4*>(step + off) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// The end of a decode-form block (here and in affine_w4_matmul.cu's
// w4_gemm_decode): the eight warps' sums, acc[j] the lane's mma j, whose A
// rows g and g + 8 are the block's columns col(j) and col(j) + 1 (col(j)
// even) and whose tokens are 2t and 2t + 1, meet in shared memory in warp
// order; with splits > 1 each block writes its f32 partial to `part`, and
// the last block of the column tile to arrive (a counter, which it resets)
// adds the splits' partials in split order; each output is rounded once to
// bf16: the same bits from every call, no atomics on the output.  The
// caller's copies have landed; `smem` holds DC_WARPS * DC_OUT floats.
template <class ColFn>
__device__ __forceinline__ void decode_finish(
    const float (&acc)[8][4], ColFn col, uint8_t* smem,
    uint16_t* __restrict__ y, float* __restrict__ part,
    int* __restrict__ count, int tile, int split, int splits, int tiles,
    int n0, int M, int N) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  __syncthreads();  // every ring is free

  // the warps' sums, in warp order: red[warp][token][column]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* r = red + warp * DC_OUT + 2 * t * DC_BN + col(j);
    *reinterpret_cast<float2*>(r) = make_float2(acc[j][0], acc[j][2]);
    *reinterpret_cast<float2*>(r + DC_BN) = make_float2(acc[j][1], acc[j][3]);
  }
  __syncthreads();
  float4 sum = reinterpret_cast<const float4*>(red)[tid];
#pragma unroll
  for (int w = 1; w < DC_WARPS; ++w) {
    const float4 v = reinterpret_cast<const float4*>(red + w * DC_OUT)[tid];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }

  if (splits > 1) {
    // this split's partial; the last block of the tile to arrive adds them
    float4* mine = reinterpret_cast<float4*>(
        part + (static_cast<size_t>(split) * tiles + tile) * DC_OUT);
    mine[tid] = sum;
    __threadfence();
    __syncthreads();
    __shared__ int last;
    if (tid == 0) last = atomicAdd(count + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          part + (static_cast<size_t>(sp) * tiles + tile) * DC_OUT) + tid);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (tid == 0) count[tile] = 0;  // ready for the next call
  }
  const int tok = tid / (DC_BN / 4), n = n0 + 4 * (tid % (DC_BN / 4));
  if (tok < M) {
    uint16_t* dst = y + static_cast<size_t>(tok) * N + n;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) dst[e] = float_to_bf16_bits(v[e]);
  }
}

template <class Dec, int kScaleRows>
__global__ void __launch_bounds__(DC_THREADS, DC_MIN_BLOCKS)
gemm_decode(const uint16_t* __restrict__ x, const int8_t* __restrict__ codes,
            Dec dec, uint16_t* __restrict__ y, float* __restrict__ part,
            int* __restrict__ count, int M, int K, int N, int splits) {
  using L = DecodeLayout<Dec, kScaleRows>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int tiles = gridDim.x;
  const int n0 = tile * DC_BN;
  // this block's stages of DC_BK rows: an even share, in split order; its
  // warp takes every DC_WARPS-th k step of them, from its own ring
  const int nst = (K + DC_BK - 1) / DC_BK;
  const int st0 = static_cast<int>(static_cast<long>(split) * nst / splits);
  const int st1 = static_cast<int>(static_cast<long>(split + 1) * nst / splits);
  const int q0 = DC_WARPS * st0 + warp;
  const int qend = min(DC_WARPS * st1, (K + 15) / 16);
  const int nq = q0 < qend ? (qend - q0 + DC_WARPS - 1) / DC_WARPS : 0;
  uint8_t* ring = smem + warp * DC_STAGES * L::STEP;
  const bool vec_codes =
      (reinterpret_cast<uintptr_t>(codes) & 15) == 0 && (N & 15) == 0;
  bool vec_scales = false;
  if constexpr (Dec::kScales)
    vec_scales =
        (reinterpret_cast<uintptr_t>(dec.scales) & 15) == 0 && (N & 7) == 0;

#pragma unroll
  for (int s = 0; s < DC_STAGES - 1; ++s) {
    if (s < nq)
      issue_step<Dec, kScaleRows>(ring + s * L::STEP, x, codes, dec, 16 * (q0 + DC_WARPS * s),
                 n0, M, K, N, lane, vec_codes, vec_scales);
    cp_async_commit();
  }

  // the decode table, one copy a lane (word e * 32 + lane holds entry e),
  // so that 32 lanes looking up 32 codes hit 32 banks
  const uint32_t aux = dec.aux(smem_u32(smem + L::RING) + 4 * lane);
  if constexpr (Dec::kTable) {
    float* table = reinterpret_cast<float*>(smem + L::RING);
    table[tid * 32] = dec.entry(tid);  // DC_THREADS == 256 entries
    __syncthreads();
    for (int w = tid; w < DC_TABLE; w += DC_THREADS)
      table[w] = table[w & ~31];
    __syncthreads();
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int i = 0; i < nq; ++i) {
    cp_async_wait<DC_STAGES - 2>();
    __syncwarp();  // every lane's copies of step i have landed, and every
                   // lane is done with the slot that step i + 2 takes
    const int ahead = i + DC_STAGES - 1;
    if (ahead < nq)
      issue_step<Dec, kScaleRows>(ring + (ahead % DC_STAGES) * L::STEP, x, codes, dec,
                 16 * (q0 + DC_WARPS * ahead), n0, M, K, N, lane, vec_codes,
                 vec_scales);
    cp_async_commit();

    const uint8_t* step = ring + (i % DC_STAGES) * L::STEP;
    // code rows 2t, 2t + 1, 2t + 8 and 2t + 9 of the step
    const uint8_t* cp = step + 2 * t * DC_CROW + 16 * g;
    const uint4 c0 = *reinterpret_cast<const uint4*>(cp);
    const uint4 c1 = *reinterpret_cast<const uint4*>(cp + DC_CROW);
    const uint4 c2 = *reinterpret_cast<const uint4*>(cp + 8 * DC_CROW);
    const uint4 c3 = *reinterpret_cast<const uint4*>(cp + 9 * DC_CROW);
    const uint8_t* xp = step + L::CODES + g * DC_XROW + 4 * t;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xp);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xp + 16);
    // the scale words of the lane's 16 columns: rows 0-7 of the step
    // (sc0, sc1) and rows 8-15 (sc2, sc3; the same words with one row)
    uint4 sc0 = make_uint4(0u, 0u, 0u, 0u), sc1 = sc0, sc2 = sc0, sc3 = sc0;
    if constexpr (Dec::kScales) {
      const uint8_t* sp = step + L::CODES + L::X + 32 * g;
      sc0 = *reinterpret_cast<const uint4*>(sp);
      sc1 = *reinterpret_cast<const uint4*>(sp + 16);
      sc2 = sc0;
      sc3 = sc1;
      if constexpr (kScaleRows == 2) {
        sc2 = *reinterpret_cast<const uint4*>(sp + 2 * DC_BN);
        sc3 = *reinterpret_cast<const uint4*>(sp + 2 * DC_BN + 16);
      }
    }
    const uint32_t w0[4] = {c0.x, c0.y, c0.z, c0.w};
    const uint32_t w1[4] = {c1.x, c1.y, c1.z, c1.w};
    const uint32_t w2[4] = {c2.x, c2.y, c2.z, c2.w};
    const uint32_t w3[4] = {c3.x, c3.y, c3.z, c3.w};
    const uint32_t sw[8] = {sc0.x, sc0.y, sc0.z, sc0.w,
                            sc1.x, sc1.y, sc1.z, sc1.w};
    const uint32_t sw8[8] = {sc2.x, sc2.y, sc2.z, sc2.w,
                             sc3.x, sc3.y, sc3.z, sc3.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // columns 2j and 2j + 1 of the lane's 16: bytes 2(j % 2) and
      // 2(j % 2) + 1 of word j / 2 of each row; scale word j of each half
      const int wi = j >> 1, b = 2 * (j & 1);
      uint32_t a0, a1, a2, a3;
      dec.pairs(w0[wi], w1[wi], w2[wi], w3[wi], b, sw[j], sw8[j], aux, a0,
                a1, a2, a3);
      mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
    }
  }
  cp_async_wait<0>();
  decode_finish(acc, [&](int j) { return 16 * g + 2 * j; }, smem, y, part,
                count, tile, split, splits, tiles, n0, M, N);
}

// ---- M > 8: tensor cores (wgmma) ------------------------------------------
// y^T = W^T x^T per block of TC_BN output columns x BM tokens: each of two
// consumer warpgroups owns 64 columns and runs wgmma m64nBMk16 with the
// dequantized weight tile (64 columns x 16 k) as the A operand in registers
// and the x tile (BM tokens x 64 k, K-major as x lies in memory, 128-byte
// swizzle) as the B operand in shared memory.  A producer warp fills a ring
// of 64-deep k stages: the x tile and the code tile (64 rows x 128 columns,
// the same swizzle) by TMA, and the MX scale rows by TMA too where one row
// serves the stage; the rest by its lanes (see gemm_tc).  Full and empty
// mbarriers pass the stages between the producer and the consumers, whose
// k loop and output staging are tma_pipe.cuh's tc_consume and tc_store.
constexpr int TC_CODES = TC_BK * TC_BN;        // code bytes a stage
constexpr int TC_SROW = 2 * TC_BN + 16;        // smem bytes a scale row of
                                               // the per-row form (padded)
constexpr int TC_MAX_STAGES = 4;
constexpr int TC_SMEM_LIMIT = 232448;          // a block's shared memory

// gemm_tc's shared memory (1024-byte aligned): a ring of stages, each the x
// tile, the code tile and SR MX scale rows (0: none; 1: the row of the
// stage, in a 1024-byte slot; TC_BK: one padded row a k row), as many
// stages as fit, at most four; then the posit8 decode table (one copy a
// lane) and the full and empty barriers.  The staged output tile reuses
// the ring.
template <class Dec, int BM, int SR>
struct TcLayout {
  static constexpr int X = BM * ROW_BYTES;  // a multiple of 1024
  static constexpr int SCALES = SR == 0 ? 0 : SR == 1 ? 1024 : SR * TC_SROW;
  static constexpr int STEP = X + TC_CODES + SCALES;
  static constexpr int TABLE = Dec::kTable ? DC_TABLE * 4 : 0;
  static constexpr int FIXED = 1024 + TABLE + 2 * TC_MAX_STAGES * 8;
  static constexpr int STAGES =
      std::min(TC_MAX_STAGES, (TC_SMEM_LIMIT - FIXED) / STEP);
  static constexpr int OUT = BM * TC_OUT_STRIDE * 2;
  static constexpr int BODY = std::max(STAGES * STEP, OUT);
  static constexpr int SMEM = 1024 + BODY + TABLE + 2 * STAGES * 8;
  static_assert(STEP % 1024 == 0 && STAGES >= 2, "stage layout");
};

// byte offset of (row r, byte c) in a tile of 128-byte rows in the 128-byte
// swizzle (16-byte chunk c / 16 of row r at (c / 16) ^ (r % 8))
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

// Code rows k0.. of columns n0.. into a stage's swizzled code tile, by the
// producer's 32 lanes with plain loads (4 columns a lane, 8 rows in flight),
// zero past K and N: where TMA cannot bring them (the codes not 16-byte
// aligned, N % 16 != 0).
__device__ __forceinline__ void copy_codes(uint8_t* tile,
                                           const int8_t* __restrict__ codes,
                                           int k0, int n0, int K, int N,
                                           int lane) {
  const int c = 4 * lane, n = n0 + c;
#pragma unroll 1
  for (int r0 = 0; r0 < TC_BK; r0 += 8) {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + r0 + i;
      const int8_t* src = codes + static_cast<size_t>(k) * N + n;
      uint32_t v = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k < K && n + b < N)
          v |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * b);
      w[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(tile + swz128(r0 + i, c)) = w[i];
  }
}

// A stage's MX scale rows of columns n0.., by the producer's lanes, zero
// past K and N: SR == 1 the scale row of k0 (where TMA cannot bring it),
// SR == TC_BK row r the scale row of k row k0 + r.  16-byte cp.async copies
// where vec (the scales 16-byte aligned, N % 8 == 0), else plain loads.
template <int SR>
__device__ __forceinline__ void copy_scales(uint8_t* rows, uint32_t rows_s,
                                            const uint16_t* __restrict__ scales,
                                            int bs, int k0, int n0, int K,
                                            int N, int lane, bool vec) {
  constexpr int STRIDE = SR == 1 ? 0 : TC_SROW;
  if (vec) {
    // 16 chunks of 8 columns a row: chunk lane % 16 of rows lane / 16 + 2i
    const int c = 8 * (lane & 15), n = n0 + c;
#pragma unroll 4
    for (int i = lane >> 4; i < SR; i += 2) {
      const int k = k0 + (SR == 1 ? 0 : i);
      const bool ok = k < K && n < N;
      cp_async16(rows_s + i * STRIDE + 2 * c,
                 ok ? scales + static_cast<size_t>(k / bs) * N + n : scales,
                 ok);
    }
  } else {
    const int c = 4 * lane, n = n0 + c;  // 4 columns a lane
#pragma unroll 8
    for (int i = 0; i < SR; ++i) {
      const int k = k0 + (SR == 1 ? 0 : i);
      const uint16_t* src = scales + static_cast<size_t>(k / bs) * N + n;
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k < K && n + e < N)
          w[e >> 1] |= static_cast<uint32_t>(src[e]) << (16 * (e & 1));
      *reinterpret_cast<uint2*>(rows + i * STRIDE + 2 * c) =
          make_uint2(w[0], w[1]);
    }
  }
}

// The A fragment wants, for each of a thread's two A rows (a = 16 w + g
// and a + 8 of its warpgroup's 64; w its warp, g = lane / 4, q = lane % 4),
// the weights at k 2q, 2q+1, 2q+8 and 2q+9 of a 16-deep step.  A row a is
// output column col = 16 w + 2g of the warpgroup's 64 and a + 8 is col + 1,
// so the two columns' codes of one k row are one 16-bit read of the code
// tile (the swizzle spreads the four rows 2q of a warp over four chunks:
// no bank conflict), and their MX scales one 32-bit read of a scale row.
// The output staging undoes the permutation.
template <class Dec, int BM, int SR>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_tc(const __grid_constant__ CUtensorMap x_map,
        const __grid_constant__ CUtensorMap c_map,
        const __grid_constant__ CUtensorMap s_map,
        const int8_t* __restrict__ codes, Dec dec, uint16_t* __restrict__ y,
        int M, int K, int N, int tma_codes, int tma_scales) {
  using L = TcLayout<Dec, BM, SR>;
  constexpr int NACC = BM / 2;  // accumulator floats a thread: 64 x BM / 128
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t table = base + L::BODY;
  const uint32_t full = table + L::TABLE;  // L::STAGES barriers, then empty
  const uint32_t empty = full + L::STAGES * 8;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * TC_BN;
  const int m0 = blockIdx.y * BM;
  const int nsteps = (K + TC_BK - 1) / TC_BK;
  // what TMA does not bring, the producer's lanes copy
  bool lanes = !tma_codes;
  if constexpr (Dec::kScales) lanes = lanes || !tma_scales;

  // full: TMA's arrival, and the lanes'
  if (tid == 0) tc_init_barriers(full, empty, L::STAGES, lanes ? 33 : 1);
  if constexpr (Dec::kTable) {
    // the decode table, one copy a lane (word e * 32 + lane holds entry e),
    // so that 32 lanes looking up 32 codes hit 32 banks
    float* t = reinterpret_cast<float*>(smem + L::BODY);
    if (tid < 256) t[tid * 32] = dec.entry(tid);
    __syncthreads();
    for (int w = tid; w < DC_TABLE; w += TC_THREADS)
      if (w & 31) t[w] = t[w & ~31];
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // the producer: the x tile (rows past M and k past K read as zero) and
    // the codes by TMA where tma_codes, the MX scale row by TMA where
    // tma_scales; the rest by the lanes, whose arrival waits for their
    // cp.async copies or, after plain stores, follows them
    bool vec_scales = false;
    if constexpr (Dec::kScales)
      vec_scales = (reinterpret_cast<uintptr_t>(dec.scales) & 15) == 0 &&
                   (N & 7) == 0;
    const bool async_only = tma_codes && vec_scales;
    for (int t = 0; t < nsteps; ++t) {
      const int st = t % L::STAGES;
      if (t >= L::STAGES) mbar_wait(empty + 8 * st, (t / L::STAGES - 1) & 1);
      const int k0 = t * TC_BK;
      const uint32_t xs = base + st * L::STEP;
      const uint32_t bar = full + 8 * st;
      if (lane == 0) {
        mbar_expect_tx(bar, L::X + (tma_codes ? TC_CODES : 0) +
                                (tma_scales ? 2 * TC_BN : 0));
        tma_load_2d(xs, &x_map, k0, m0, bar);
        if (tma_codes) tma_load_2d(xs + L::X, &c_map, n0, k0, bar);
        if constexpr (Dec::kScales)
          if (tma_scales)
            tma_load_2d(xs + L::X + TC_CODES, &s_map, n0, k0 / dec.bs, bar);
      }
      if (!lanes) continue;
      uint8_t* stage = smem + st * L::STEP;
      if (!tma_codes) copy_codes(stage + L::X, codes, k0, n0, K, N, lane);
      if constexpr (Dec::kScales)
        if (!tma_scales)
          copy_scales<SR>(stage + L::X + TC_CODES, xs + L::X + TC_CODES,
                          dec.scales, dec.bs, k0, n0, K, N, lane, vec_scales);
      if (async_only) {
        cp_async_arrive(bar);
      } else {
        cp_async_wait<0>();
        mbar_arrive(bar);
      }
    }
    cp_async_wait<0>();
    return;
  }

  const int q = lane & 3;
  // this thread's A rows a and a + 8: output columns col and col + 1
  const int col = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + 2 * (lane >> 2);
  const uint32_t aux = dec.aux(table + 4 * lane);
  // the stage's codes of both columns, read before its first dequant:
  // cw[2kk] holds k rows 16kk + 2q (bytes 0, 1: col, col + 1) and
  // 16kk + 2q + 1 (bytes 2, 3), cw[2kk + 1] rows 16kk + 2q + 8 and + 9
  uint32_t cw[8];
  const uint8_t* ss = nullptr;  // the stage's scale rows
  auto load = [&](int st) {
    const uint8_t* cs = smem + st * L::STEP + L::X;
    ss = cs + TC_CODES;
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int r = 8 * h + 2 * q;
      const uint32_t lo =
          *reinterpret_cast<const uint16_t*>(cs + swz128(r, col));
      const uint32_t hi =
          *reinterpret_cast<const uint16_t*>(cs + swz128(r + 1, col));
      cw[h] = lo | (hi << 16);
    }
  };
  auto frag = [&](int kk, uint32_t(&a)[4]) {
    // both columns' scales, one row for the stage, read again each k step:
    // held across the stage they made ptxas serialize the 256-token form's
    // products (C7512)
    uint32_t s_all = 0u;
    if constexpr (SR == 1)
      s_all = *reinterpret_cast<const uint32_t*>(ss + 2 * col);
    if constexpr (SR == TC_BK) {
      const uint8_t* sp = ss + (16 * kk + 2 * q) * TC_SROW + 2 * col;
      dec.tc_frag(cw[2 * kk], cw[2 * kk + 1],
                  *reinterpret_cast<const uint32_t*>(sp),
                  *reinterpret_cast<const uint32_t*>(sp + TC_SROW),
                  *reinterpret_cast<const uint32_t*>(sp + 8 * TC_SROW),
                  *reinterpret_cast<const uint32_t*>(sp + 9 * TC_SROW), aux, a);
    } else {
      dec.tc_frag(cw[2 * kk], cw[2 * kk + 1], s_all, s_all, s_all, s_all, aux,
                  a);
    }
  };
  float acc[NACC];
  tc_consume<BM, L::STAGES>(acc, full, empty, base, L::STEP, nsteps, lane,
                            load, frag);
  // the permutation of the columns undone: a thread's two columns are
  // adjacent
  tc_store<BM, 1>(acc, reinterpret_cast<uint16_t*>(smem), y, col, q, tid, m0,
                  n0, M, N);
}

template <class Dec, int BM, int SR>
cudaError_t launch_tc(const uint16_t* x, const int8_t* codes, const Dec& dec,
                      uint16_t* y, int M, int K, int N, cudaStream_t s) {
  using L = TcLayout<Dec, BM, SR>;
  // x (M, K) as BM x 64 boxes in the 128-byte swizzle wgmma reads
  CUtensorMap x_map, c_map, s_map;
  cudaError_t err = tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x,
                               K, M, 2, TC_BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  c_map = s_map = x_map;
  // the codes as 64-row boxes of TC_BN bytes in the same swizzle, where
  // their rows are 16-byte aligned
  const int tma_codes =
      (reinterpret_cast<uintptr_t>(codes) & 15) == 0 && N % 16 == 0;
  if (tma_codes &&
      (err = tensor_map(&c_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, K, 1,
                        TC_BN, TC_BK, CU_TENSOR_MAP_SWIZZLE_128B)) !=
          cudaSuccess)
    return err;
  // the stage's scale row as a box of TC_BN values, where one row serves
  // the stage and the rows are 16-byte aligned
  int tma_scales = 0;
  if constexpr (Dec::kScales) {
    tma_scales = SR == 1 &&
                 (reinterpret_cast<uintptr_t>(dec.scales) & 15) == 0 &&
                 N % 8 == 0;
    if (tma_scales &&
        (err = tensor_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          dec.scales, N, K / dec.bs, 2, TC_BN, 1,
                          CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess)
      return err;
  }
  auto kern = gemm_tc<Dec, BM, SR>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + BM - 1) / BM);
  kern<<<grid, TC_THREADS, L::SMEM, s>>>(x_map, c_map, s_map, codes, dec, y,
                                          M, K, N, tma_codes, tma_scales);
  return cudaGetLastError();
}

template <class Dec, int SR>
cudaError_t launch_tc_tile(const uint16_t* x, const int8_t* codes,
                           const Dec& dec, uint16_t* y, int M, int K, int N,
                           int sms, cudaStream_t s) {
  switch (pick_tile_m(M, N, TC_BN, sms)) {
    case 64:
      return launch_tc<Dec, 64, SR>(x, codes, dec, y, M, K, N, s);
    case 128:
      return launch_tc<Dec, 128, SR>(x, codes, dec, y, M, K, N, s);
    default:
      return launch_tc<Dec, 256, SR>(x, codes, dec, y, M, K, N, s);
  }
}

template <class Dec, int kScaleRows>
cudaError_t launch_decode(const uint16_t* x, const int8_t* codes,
                          const Dec& dec, uint16_t* y, float* part, int* count,
                          int M, int K, int N, int splits, cudaStream_t s) {
  auto kern = gemm_decode<Dec, kScaleRows>;
  constexpr int smem = DecodeLayout<Dec, kScaleRows>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + DC_BN - 1) / DC_BN, splits);
  kern<<<grid, DC_THREADS, smem, s>>>(x, codes, dec, y, part, count, M, K, N,
                                      splits);
  return cudaSuccess;
}

// x (M, K) bf16 16-byte aligned, codes (K, N) int8, y (M, N) bf16, all
// contiguous, K % 8 == 0; `sms` the card's SM count.  The decode form runs
// where decode_plan(dec, M, K, N, sms) gives splits > 0, gemm_tc
// elsewhere.  Where the plan gives splits > 1, `part` must hold its
// part_floats floats (any contents) and `count` its counters ints, zero
// (each call leaves them zero); the capacities say how much each holds,
// and a launch that would need more is refused.
template <class Dec>
int launch(const void* x, const void* codes, const Dec& dec, void* y,
           void* part, int part_floats, void* count, int counters, int M,
           int K, int N, int sms, cudaStream_t s) {
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* cp = static_cast<const int8_t*>(codes);
  auto* yp = static_cast<uint16_t*>(y);
  if (K % 8) return static_cast<int>(cudaErrorInvalidValue);
  const DecodePlan plan = decode_plan(dec, M, K, N, sms);
  if (plan.splits) {
    if (plan.splits > 1 &&
        (part == nullptr || count == nullptr ||
         part_floats < plan.part_floats || counters < plan.counters))
      return static_cast<int>(cudaErrorInvalidValue);
    auto* pp = static_cast<float*>(part);
    auto* cnt = static_cast<int*>(count);
    cudaError_t err;
    if constexpr (Dec::kScales) {
      err = dec.bs % 16
          ? launch_decode<Dec, 2>(xp, cp, dec, yp, pp, cnt, M, K, N,
                                  plan.splits, s)
          : launch_decode<Dec, 1>(xp, cp, dec, yp, pp, cnt, M, K, N,
                                  plan.splits, s);
    } else {
      err = launch_decode<Dec, 1>(xp, cp, dec, yp, pp, cnt, M, K, N,
                                  plan.splits, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err;
  if constexpr (Dec::kScales)
    err = dec.bs % TC_BK
        ? launch_tc_tile<Dec, TC_BK>(xp, cp, dec, yp, M, K, N, sms, s)
        : launch_tc_tile<Dec, 1>(xp, cp, dec, yp, M, K, N, sms, s);
  else
    err = launch_tc_tile<Dec, 0>(xp, cp, dec, yp, M, K, N, sms, s);
  return static_cast<int>(err);
}

}  // namespace bsg
