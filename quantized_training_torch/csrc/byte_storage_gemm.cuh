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
// M > 8 (gemm_tiled, CUDA cores): a 64x64 output tile per block, K walked 64
// rows at a time; the code tile is decoded once into shared memory and
// reused by all 64 rows; each thread accumulates a 4x4 tile with CUDA-core
// FMAs.  It also serves M <= 8 where the decoder refuses the decode form.
//
// A decoder is a struct with, for gemm_tiled, `setup(float* table)`, run by
// every block before the first decode (it may fill the 256-float shared
// table and must end in __syncthreads if it does), and `float
// operator()(int code, int k, int n, const float* table)`; and, for
// gemm_decode, `kTable` (a 256-entry table of `entry(i)` values, one copy a
// lane), `kScales` (bf16 scale rows `scales`, one per `bs` rows of K, to be
// streamed beside the codes), `bool decode_ok() const`, `uint32_t
// aux(uint32_t lane_table) const` (a register the decode keeps: the lane's
// table address, or a constant) and `void pairs(...)`, which makes the A
// registers of one mma from the four code rows and the scale words of
// their two 8-row halves (see PositDecoder and MxDecoder).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma_tile.cuh"

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

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
  __syncthreads();  // every ring is free

  // the warps' sums, in warp order: red[warp][token][column]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 16 * g + 2 * j;
    float* r = red + warp * DC_OUT + 2 * t * DC_BN + col;
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
// contiguous, K % 8 == 0.  Where decode_plan(dec, M, K, N, sms) gives
// splits > 1, `part` must hold its part_floats floats (any contents) and
// `count` its counters ints, zero (each call leaves them zero); the
// capacities say how much each holds, and a launch that would need more
// is refused.
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
  } else {
    dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    gemm_tiled<Dec><<<grid, TB_THREADS, 0, s>>>(xp, cp, dec, yp, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bsg
