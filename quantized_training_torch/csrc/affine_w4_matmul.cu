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
// qparams (K*N*NBITS/8 + K*N/8 per GEMM at group 64) over 3.35 TB/s; at
// prefill the 2*M*K*N operations, on the tensor cores.  Design:
//   * M <= 8 (CUDA cores): one thread per output column, eight warps per
//     block splitting K by groups, each warp loading a group's words for 32
//     adjacent columns (128-byte coalesced rows) before using them, so eight
//     loads are in flight per warp; x rows are read through the L1 cache;
//     the eight partial sums meet in shared memory.  Words are unpacked by a
//     left shift on the unsigned word and an arithmetic right shift of its
//     int32 reinterpretation.
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

#include "tma_pipe.cuh"
#include "wgmma_tile.cuh"

namespace {

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint16_t float_to_bf16_bits(float v) {
  uint32_t u = __float_as_uint(round_bf16(v));
  return static_cast<uint16_t>(u >> 16);
}

template <int NBITS>
__device__ __forceinline__ float dequant(uint32_t word, int p, float zp,
                                         float sf) {
  constexpr int MID = 1 << (NBITS - 1);
  const int32_t c = static_cast<int32_t>(word << (32 - NBITS * (p + 1))) >>
                    (32 - NBITS);  // c - MID
  return round_bf16((static_cast<float>(c + MID) - zp) * sf);
}

// ---- M <= 8 ---------------------------------------------------------------
constexpr int SM_MAXM = 8;
constexpr int SM_WARPS = 8;
constexpr int SM_BN = 32;
constexpr int SM_CHUNK = 8;  // words loaded before use, per lane

template <int NBITS>
__global__ void __launch_bounds__(SM_WARPS * 32)
w4_gemm_small_m(const uint16_t* __restrict__ x,
                const int32_t* __restrict__ codes,
                const float* __restrict__ sf, const float* __restrict__ zp,
                uint16_t* __restrict__ y, int M, int K, int N, int group) {
  constexpr int PER = 32 / NBITS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * SM_BN + lane;
  const int ngroups = K / group;
  const int gwords = group / PER;

  float acc[SM_MAXM];
#pragma unroll
  for (int m = 0; m < SM_MAXM; ++m) acc[m] = 0.f;

  if (n < N) {
    for (int g = warp; g < ngroups; g += SM_WARPS) {
      const float s = sf[static_cast<size_t>(g) * N + n];
      const float z = zp[static_cast<size_t>(g) * N + n];
      for (int w0 = 0; w0 < gwords; w0 += SM_CHUNK) {
        const int nw = min(SM_CHUNK, gwords - w0);
        const int r0 = g * gwords + w0;  // first word row of this chunk
        uint32_t words[SM_CHUNK];
#pragma unroll
        for (int w = 0; w < SM_CHUNK; ++w)
          words[w] = w < nw ? static_cast<uint32_t>(
                                  codes[static_cast<size_t>(r0 + w) * N + n])
                            : 0u;
#pragma unroll
        for (int w = 0; w < SM_CHUNK; ++w) {
          if (w >= nw) break;
          float wv[PER];
#pragma unroll
          for (int p = 0; p < PER; ++p) wv[p] = dequant<NBITS>(words[w], p, z, s);
          const int k0 = (r0 + w) * PER;
#pragma unroll
          for (int m = 0; m < SM_MAXM; ++m) {
            if (m >= M) break;
            float a = acc[m];
#pragma unroll
            for (int h = 0; h < PER / 8; ++h) {  // 8 x values per 16 bytes
              const uint4 xv = *reinterpret_cast<const uint4*>(
                  x + static_cast<size_t>(m) * K + k0 + 8 * h);
              const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                a += bf16_bits_to_float(xw[q] & 0xffffu) * wv[8 * h + 2 * q];
                a += bf16_bits_to_float(xw[q] >> 16) * wv[8 * h + 2 * q + 1];
              }
            }
            acc[m] = a;
          }
        }
      }
    }
  }

  __shared__ float red[SM_WARPS][SM_MAXM][SM_BN];
#pragma unroll
  for (int m = 0; m < SM_MAXM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  // SM_WARPS == SM_MAXM: warp index doubles as the output row
  const int m = warp;
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < SM_WARPS; ++w) sum += red[w][m][lane];
  if (m < M && n < N)
    y[static_cast<size_t>(m) * N + n] = float_to_bf16_bits(sum);
}

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

// w = bf16((c - zp) * sf) for the codes at bits b.. of t, as dequant<NBITS>:
// the field, its top bit flipped (c = centered + MID), is OR'd into the
// mantissa of 2^(23-b), and subtracting 2^(23-b) gives float(c) exactly
__device__ __forceinline__ float deq_at(uint32_t t, uint32_t mask,
                                        uint32_t magic, float base, float z,
                                        float s) {
  const float c = __fsub_rn(__uint_as_float((t & mask) ^ magic), base);
  return __fmul_rn(__fsub_rn(c, z), s);
}

// w4: fields 2q and 2q+1 of a word (bits 8q..8q+7), packed lo, hi
__device__ __forceinline__ uint32_t deq4_pair(uint32_t w, int q, float z,
                                              float s) {
  const uint32_t t = w >> (8 * q);
  return pack_bf16(deq_at(t, 0xfu, 0x4b000008u, 8388608.f, z, s),
                   deq_at(t, 0xf0u, 0x49000080u, 524288.f, z, s));
}

// w2: fields 2q, 2q+1 (bits 4q..4q+3) into lo and 2q+8, 2q+9 (bits
// 4q+16..4q+19) into hi
__device__ __forceinline__ void deq2_quad(uint32_t w, int q, float z, float s,
                                          uint32_t& lo, uint32_t& hi) {
  const uint32_t t = w >> (4 * q);
  lo = pack_bf16(deq_at(t, 0x3u, 0x4b000002u, 8388608.f, z, s),
                 deq_at(t, 0xcu, 0x4a000008u, 2097152.f, z, s));
  hi = pack_bf16(deq_at(t, 0x30000u, 0x43020000u, 128.f, z, s),
                 deq_at(t, 0xc0000u, 0x42080000u, 32.f, z, s));
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

// the token tile on this card (tma_pipe.cuh:pick_tile_m)
int pick_tile_m(int M, int N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return pick_tile_m(M, N, TC_BN, sms);
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// the largest M that affine_w4_matmul serves with w4_gemm_small_m (CUDA
// cores); a larger M runs w4_gemm_tc (tensor cores)
int affine_w4_matmul_small_m() { return SM_MAXM; }

// x (M, K) bf16, codes (K/PER, N) int32, sf/zp (K/group, N) f32, y (M, N)
// bf16, all contiguous; nbits 4 or 2 (PER = 32/nbits); K % group == 0,
// group % PER == 0, x 16-byte aligned.
int affine_w4_matmul(const void* x, const void* codes, const void* sf,
                     const void* zp, void* y, int M, int K, int N, int group,
                     int nbits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* cp = static_cast<const int32_t*>(codes);
  const auto* sp = static_cast<const float*>(sf);
  const auto* zpp = static_cast<const float*>(zp);
  auto* yp = static_cast<uint16_t*>(y);
  if (nbits != 4 && nbits != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= SM_MAXM) {
    dim3 grid((N + SM_BN - 1) / SM_BN);
    if (nbits == 4)
      w4_gemm_small_m<4><<<grid, SM_WARPS * 32, 0, s>>>(xp, cp, sp, zpp, yp,
                                                        M, K, N, group);
    else
      w4_gemm_small_m<2><<<grid, SM_WARPS * 32, 0, s>>>(xp, cp, sp, zpp, yp,
                                                        M, K, N, group);
    return static_cast<int>(cudaGetLastError());
  }
  const int tile_m = pick_tile_m(M, N);
  const cudaError_t err =
      nbits == 4
          ? launch_tc_tile<4>(xp, cp, sp, zpp, yp, M, K, N, group, tile_m, s)
          : launch_tc_tile<2>(xp, cp, sp, zpp, yp, M, K, N, group, tile_m, s);
  return static_cast<int>(err);
}

}  // extern "C"
