// Causal GQA flash attention backward on Hopper's tensor cores: three entry
// points over two kernels that recompute the score tiles from q, k and the
// forward's row logsumexp, so that no (S, T) tensor exists in device memory.
//   flash_bwd_di:  di = sum_j rowsum(p * err(bf16(dO V^T)))      f32 (B, H, S)
//   flash_bwd_dq:  dq = sum_j bf16(p * (dp - di) * scale) @ K    bf16 (B, H, S, D)
//   flash_bwd_dkv: dv_h = sum_i pv^T dO, dk_h = sum_i bf16(ds)^T Q, per
//                  query head                                     bf16 (B, H, T, D)
//   q, dO (B, H, S, D), k/v (B, KV, T, D) bf16; lse, di f32 (B, H, S); query
//   row i sits at absolute position q_offset + i; head h reads kv head
//   h / (H / KV); masked scores give p = 0.
//
// Replaces quantized_training_tpu/ops/pallas/flash_attention.py:229
// (_bwd_di_kernel), :284 (_bwd_dq_kernel) and :348 (_bwd_dkv_kernel),
// reached through flash_attention's custom_vjp (:599-735).  The rounding
// points are the TPU kernels': dO arrives bf16 and is widened to f32;
// s = q.k and dp = dO.v sum in f32, s * scale is rounded before the lse is
// subtracted (as the forward does); p = exp(s * scale - lse) is the
// unrounded softmax (straight-through); with an err format dp is rounded to
// bf16 and then through it (:276, :337, :407), without one it stays f32;
// ds = p * (dp - di) * scale is rounded to bf16 before the dq and dk
// products (:340, :410); the dv operand is round(bf16(p)) with a p format
// (:396-402), else bf16(p) (the tensor cores take bf16 operands; the TPU
// kernel multiplies the f32 p).  dq, dk_h and dv_h are f32 sums rounded to
// bf16 once.  The GQA group sum and the exit taps run outside (:699-712).
//
// What bounds them on an H100: the causal operations, 2*S^2*D/2 per head
// for each product (di: q.k and dO.v; dq: those and ds.K; dkv: those,
// p^T.dO and ds^T.Q), over the 989 TFLOP/s bf16 tensor-core rate, and the
// roundings of dp (and p) on the CUDA cores, some 25 integer operations an
// element for posit8.  Design (wgmma_tile.cuh's tiles and fragments):
//   * row kernel (di, dq): one block of two warpgroups per (128-row query
//     tile, head, batch), q tiles launched longest first; each warpgroup
//     owns 64 query rows.  Q and dO (128 x D) stay in shared memory; K and
//     V tiles of 64 keys come through a three-stage cp.async ring.  S = Q
//     K^T and dP = dO V^T are wgmma m64n64k16 products (Q, dO, K and V
//     K-major); p, the dp tap and ds are applied to the accumulator
//     fragments in registers; di sums p * err(dp) by row and reduces it
//     over the quad of threads that hold the row; for dq, ds is packed into
//     the A operand of dQ += dS K (m64nDk16), with the K tile already in
//     shared memory as the MN-major B operand;
//   * column kernel (dk, dv): one block of two warpgroups per (128-key
//     tile, query head, batch), key tiles with the most query tiles first;
//     each warpgroup owns 64 keys.  K and V stay in shared memory; Q and dO
//     tiles of 32 queries, with their lse and di, come through a
//     three-stage ring from the first tile that sees the block's keys on.
//     S^T = K Q^T and dP^T = V dO^T are m64n32k16 products; p^T (rounded
//     through the p format) is the A operand of dV += P^T dO and ds^T that
//     of dK += dS^T Q, dO and Q the MN-major B operands (m64nDk16).  32
//     queries a tile keep dk, dv (D/2 floats a thread each), s, dp and a
//     chunk temporary within the registers at D = 128.  dk_h and dv_h stay
//     per query head: stacking a GQA group's heads would move the group sum
//     before the bf16 rounding;
//   * where a format follows a product (dp under err, s under the p
//     format in the column kernel) the product is summed 16 deep at a time
//     and the chunks added in f32 (dot_tile), as the forward's two-pass
//     scores: the tensor cores' chained sums truncate, and a format step
//     turns a last bit into a whole step;
//   * under the error tap only the bf16 rounding of dp matters, and the
//     tensor cores' truncating sums leave some dp within their error of a
//     bf16 rounding midpoint: where the two bf16
//     neighbours of such a dp round apart through the format (a posit8
//     step of dp at a large p moves di far past its bound), the warp
//     computes the exact dot together (in double) and takes it instead
//     (settle_midpoints), so that err(bf16(dp)) is the exact dot's, as a
//     float64 reference at the TPU kernels' rounding points gives it;
//   * no atomics: every output element has one owner, so a repeated call
//     gives the same bits.  Tiles above the diagonal are never loaded, and a
//     warpgroup skips those wholly above its own rows or keys; any S and T
//     (ragged tiles are masked), any q_offset >= 0, D 64 or 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qt_round.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int NTHREADS = 256;       // two warpgroups
constexpr int NSTAGE = 3;           // depth of the walked tiles' ring
// row kernel (di, dq)
constexpr int BQ = 128;             // query rows per block
constexpr int BK = 64;              // keys per walked tile
constexpr int NS = BK / 8 * 4;      // score elements per thread
// column kernel (dk, dv)
constexpr int BKV = 128;            // keys per block
constexpr int BQT = 32;             // queries per walked tile
constexpr int NC = BQT / 8 * 4;     // score elements per thread

template <int D>
struct RowLayout {
  static constexpr int Q_BYTES = BQ * D * 2;       // Q, and dO beside it
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // + 1024: the swizzle atoms need 1024-byte alignment
  static constexpr int AMAX_BYTES = 2 * BK * 4;    // each warpgroup's key maxima
  static constexpr int SMEM_BYTES =
      2 * Q_BYTES + NSTAGE * STAGE_BYTES + AMAX_BYTES + 1024;
  static_assert(SMEM_BYTES <= 232448, "over the H100's shared memory");
};

template <int D>
struct ColLayout {
  static constexpr int KV_BYTES = BKV * D * 2;     // K, and V beside it
  static constexpr int Q_BYTES = BQT * D * 2;      // one Q or dO tile
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  static constexpr int ROWS_BYTES = 2 * BQT * 4;   // a tile's lse and di
  static constexpr int AMAX_BYTES = 2 * BQT * 4;   // each warpgroup's query maxima
  static constexpr int SMEM_BYTES =
      2 * KV_BYTES + NSTAGE * (STAGE_BYTES + ROWS_BYTES) + AMAX_BYTES + 1024;
  static_assert(SMEM_BYTES <= 232448, "over the H100's shared memory");
};

struct Geometry {
  int H, KV, S, T;
  float scale;
  int causal, q_offset;
};

// A fragment of bf16 values through a format the backward takes (posit,
// fp8, fp, int: the wrappers refuse the NF and cast kinds, so their code
// stays out of these kernels; any other kind gives NaN), the kind switched
// once
template <int N>
__device__ __forceinline__ void round_frag(float (&x)[N], const QtFormat& f) {
  switch (f.kind) {
    case QT_POSIT: qt_round_each<true, QT_POSIT>(x, f); return;
    case QT_FP8: qt_round_each<true, QT_FP8>(x, f); return;
    case QT_FP: qt_round_each<true, QT_FP>(x, f); return;
    case QT_INT: qt_round_each<true, QT_INT>(x, f); return;
    default: qt_round_each<true, -1>(x, f); return;
  }
}

// dp tapped by the error format: rounded to bf16, then through it (kind
// QT_NONE: the f32 dp)
template <int N>
__device__ __forceinline__ void err_tap(float (&dp)[N], const QtFormat& err) {
  if (err.kind == QT_NONE) return;
#pragma unroll
  for (int i = 0; i < N; ++i) dp[i] = round_bf16(dp[i]);
  round_frag(dp, err);
}

// ---- the tap's rounding of dp, settled where the tensor cores' sum is not
// enough ------------------------------------------------------------------
// The 16-byte chunk cc of row r of a swizzled tile of ROWS rows
template <int ROWS>
__device__ __forceinline__ uint4 tile_chunk(const uint8_t* tile, int r, int cc) {
  return *reinterpret_cast<const uint4*>(
      tile + (cc >> 3) * (ROWS * ROW_BYTES) + r * ROW_BYTES +
      (((cc & 7) ^ (r & 7)) << 4));
}

// max |x| over chunks c0..c1-1 of row r of a swizzled tile (on the bf16
// bits: the order of |x| is that of its bits)
template <int ROWS>
__device__ __forceinline__ float row_amax(const uint8_t* tile, int r, int c0,
                                          int c1) {
  uint32_t m = 0;
  for (int cc = c0; cc < c1; ++cc) {
    const uint4 x = tile_chunk<ROWS>(tile, r, cc);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      m = max(m, max(w[e] & 0x7fff0000u, (w[e] << 16) & 0x7fff0000u));
  }
  return __uint_as_float(m);
}

// The dot of row ra of swizzled tile a (RA rows) and row rb of swizzled
// tile b (RB rows), D values each, exactly, by the 32 lanes of a warp
// together (each D/32 products, then a butterfly sum): bf16 products are
// exact in f32, and their sum in double is exact at the magnitudes of
// these rows (or off by a part in 2^53); rounded once to f32, in every lane.
template <int D, int RA, int RB>
__device__ __forceinline__ float warp_exact_dot(const uint8_t* a, int ra,
                                                const uint8_t* b, int rb,
                                                int lane) {
  constexpr int PER = D / 32;          // values a lane: 4 or 2
  const int d0 = lane * PER;
  const int cc = d0 >> 3;              // its 16-byte chunk, and the offset
  const int off = (d0 & 7) * 2;        // in it
  const uint8_t* pa = a + (cc >> 3) * (RA * ROW_BYTES) + ra * ROW_BYTES +
                      (((cc & 7) ^ (ra & 7)) << 4) + off;
  const uint8_t* pb = b + (cc >> 3) * (RB * ROW_BYTES) + rb * ROW_BYTES +
                      (((cc & 7) ^ (rb & 7)) << 4) + off;
  uint32_t xw[2], yw[2];
  if constexpr (PER == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(pa);
    const uint2 y = *reinterpret_cast<const uint2*>(pb);
    xw[0] = x.x; xw[1] = x.y; yw[0] = y.x; yw[1] = y.y;
  } else {
    xw[0] = *reinterpret_cast<const uint32_t*>(pa); xw[1] = 0u;
    yw[0] = *reinterpret_cast<const uint32_t*>(pb); yw[1] = 0u;
  }
  double acc = 0.0;
#pragma unroll
  for (int e = 0; e < PER / 2; ++e) {
    acc += static_cast<double>(__fmul_rn(__uint_as_float(xw[e] << 16),
                                         __uint_as_float(yw[e] << 16)));
    acc += static_cast<double>(__fmul_rn(__uint_as_float(xw[e] & 0xffff0000u),
                                         __uint_as_float(yw[e] & 0xffff0000u)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return __double2float_rn(acc);
}

// The tap rounds dp to bf16 first, so dp's f32 value matters only through
// which side of a bf16 rounding midpoint it lies on.  The tensor cores'
// 16-deep sums truncate: near a midpoint the f32 dp from them can sit on
// the other side of it than the exact dot, and where the two bf16
// neighbours round apart through the format that is a whole format step
// (a posit8 step of dp at a large p moves di by far more than its
// bound).  So every element within bound(i, dp) of a midpoint whose
// neighbours round apart takes the exact dot instead: exact(i, leader) is
// the dot of element i of lane leader, which the warp computes together.
template <int N, typename Bound, typename Exact>
__device__ __forceinline__ void settle_midpoints(float (&dp)[N],
                                                 const QtFormat& err,
                                                 Bound bound, Exact exact,
                                                 int lane) {
  uint32_t near = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float mid =
        __uint_as_float((__float_as_uint(dp[i]) & 0xffff0000u) | 0x8000u);
    if (fabsf(dp[i] - mid) <= bound(i, dp[i])) near |= 1u << i;
  }
  // each lane keeps those of its elements whose neighbours round apart
  uint32_t todo = 0;
  while (near) {
    const int i = __ffs(near) - 1;
    near &= near - 1;
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (e == i) d = dp[e];
    const uint32_t lo = __float_as_uint(d) & 0xffff0000u;
    if (qt_round<true>(__uint_as_float(lo), err) !=
        qt_round<true>(__uint_as_float(lo + 0x10000u), err))
      todo |= 1u << i;
  }
  // the warp takes their exact dots one at a time
  for (uint32_t lanes = __ballot_sync(0xffffffffu, todo != 0); lanes;
       lanes = __ballot_sync(0xffffffffu, todo != 0)) {
    const int leader = __ffs(lanes) - 1;
    const int i = __ffs(__shfl_sync(0xffffffffu, todo, leader)) - 1;
    const float x = exact(i, leader);
    if (lane == leader) {
      todo &= todo - 1;
#pragma unroll
      for (int e = 0; e < N; ++e)
        if (e == i) dp[e] = x;
    }
  }
}

// The bound on a tensor-core dot's error: each 16-deep chunk off by up to
// 2^-21 of the largest |product| (at most amax(a) * amax(b)), and the f32
// additions of the chunks by up to 2^-20 |dp|
template <int D>
__device__ __forceinline__ float dot_error_bound(float amax_a, float amax_b,
                                                 float dp) {
  return (D / 16) * 0x1p-21f * amax_a * amax_b + 0x1p-20f * fabsf(dp);
}

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// acc = A B^T over D for two K-major swizzled tiles, a(kk) and b(kk) their
// descriptors at k step kk: one chain of D/16 steps, or (chunked) each
// 16-deep step summed alone and the steps added in f32 with round to
// nearest, one temporary in flight at a time (flash_attn_fwd.cu's scores())
template <int D, int N, typename DescA, typename DescB>
__device__ __forceinline__ void dot_tile(float (&acc)[N], DescA a, DescB b,
                                         bool chunked) {
  if (!chunked) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss(acc, a(kk), b(kk), kk > 0);
    wg_commit_wait();
    fence_regs(acc);
  } else {
    float t[N];
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      fence_regs(t);
      wg_fence();
      wgmma_ss(t, a(kk), b(kk), 0);
      wg_commit_wait();
      fence_regs(t);
#pragma unroll
      for (int i = 0; i < N; ++i)
        acc[i] = kk == 0 ? t[i] : __fadd_rn(acc[i], t[i]);
    }
  }
}

// p = exp(s * scale - lse) in place (0 where masked); the product is
// rounded before the difference, as the forward scales s.  Row kernel: the
// thread's rows a and b (absolute positions qpos_a, qpos_a + 8) over the
// key tile at k0.  MASK: the tile reaches past T or above a row's diagonal.
template <bool MASK>
__device__ __forceinline__ void row_probs(float (&s)[NS], float scale,
                                          float lse_a, float lse_b, int k0,
                                          int col0, int qpos_a,
                                          const Geometry& g) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
    const bool seen = kpos < g.T &&
                      (!g.causal || kpos <= qpos_a + 8 * row_b(i));
    s[i] = (MASK && !seen)
               ? 0.f
               : expf(__fsub_rn(__fmul_rn(s[i], scale),
                                row_b(i) ? lse_b : lse_a));
  }
}

// Column kernel: p^T for the thread's keys key_a and key_a + 8 over the
// query tile at q0, its lse staged at lse_t.  MASK: the tile reaches past
// S, the keys past T, or a key above a query's diagonal.
template <bool MASK>
__device__ __forceinline__ void col_probs(float (&s)[NC], float scale,
                                          const float* lse_t, int q0,
                                          int col0, int key_a,
                                          const Geometry& g) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = 8 * (i >> 2) + col0 + (i & 1);
    const int key = key_a + 8 * row_b(i);
    const bool seen = q0 + c < g.S && key < g.T &&
                      (!g.causal || key <= g.q_offset + q0 + c);
    s[i] = (MASK && !seen)
               ? 0.f
               : expf(__fsub_rn(__fmul_rn(s[i], scale), lse_t[c]));
  }
}

// DQ = false: di = rowsum(p * err(dp)); DQ = true: dq
template <int D, bool DQ>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_rows(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const uint16_t* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ di_in,
               float* __restrict__ di_out, uint16_t* __restrict__ dq,
               Geometry g, QtFormat err) {
  using L = RowLayout<D>;
  constexpr int NO = D / 8 * 4;  // dq elements per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t q_s = (base + 1023u) & ~1023u;
  const uint32_t do_s = q_s + L::Q_BYTES;
  const uint32_t kv_s = do_s + L::Q_BYTES;
  float* amax_k = reinterpret_cast<float*>(
      smem_raw + (kv_s + NSTAGE * L::STAGE_BYTES - base));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int h = blockIdx.x % g.H;
  const int b = blockIdx.x / g.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int kvh = h / (g.H / g.KV);
  const size_t bh = static_cast<size_t>(b) * g.H + h;
  const uint16_t* kp = k + (static_cast<size_t>(b) * g.KV + kvh) * g.T * D;
  const uint16_t* vp = v + (static_cast<size_t>(b) * g.KV + kvh) * g.T * D;

  // this thread's rows (a, and b = a + 8) in the block
  const int row_a = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int ra = q0 + row_a, rb = ra + 8;
  const float lse_a = ra < g.S ? lse[bh * g.S + ra] : 0.f;
  const float lse_b = rb < g.S ? lse[bh * g.S + rb] : 0.f;
  const float di_a = (DQ && ra < g.S) ? di_in[bh * g.S + ra] : 0.f;
  const float di_b = (DQ && rb < g.S) ? di_in[bh * g.S + rb] : 0.f;

  // keys the block can see, and those its warpgroup's rows can see
  const int q_last = min(q0 + BQ, g.S) - 1;
  const int kend = g.causal ? max(0, min(g.T, g.q_offset + q_last + 1)) : g.T;
  const int n_tiles = (kend + BK - 1) / BK;
  const int wg_first = q0 + wg * 64;
  const int wg_kend =
      wg_first >= g.S ? 0
      : g.causal ? max(0, min(g.T, g.q_offset + min(wg_first + 63, g.S - 1) + 1))
                 : g.T;

  auto stage = [&](int j) { return kv_s + (j % NSTAGE) * L::STAGE_BYTES; };
  auto issue = [&](int j) {
    if (j < n_tiles) {
      load_tile<D, BK, NTHREADS>(stage(j), kp, j * BK, g.T, tid);
      load_tile<D, BK, NTHREADS>(stage(j) + L::KV_BYTES, vp, j * BK, g.T, tid);
    }
    cp_async_commit();
  };
  // the oldest tile in flight is in shared memory and visible to wgmma, and
  // every warpgroup is done with the stage the next issue overwrites
  auto arrive = [&]() {
    cp_async_wait<NSTAGE - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  // a tile that reaches past T or above the warpgroup's first row's diagonal
  auto edge = [&](int k0) {
    return k0 + BK > g.T || (g.causal && k0 + BK - 1 > g.q_offset + wg_first);
  };
  auto desc_q = [&](int kk) {
    return kmajor_desc<BQ>(q_s + wg * (64 * ROW_BYTES), kk);
  };
  auto desc_do = [&](int kk) {
    return kmajor_desc<BQ>(do_s + wg * (64 * ROW_BYTES), kk);
  };

  float acc[DQ ? NO : 1];
#pragma unroll
  for (int i = 0; i < (DQ ? NO : 1); ++i) acc[i] = 0.f;
  float sum_a = 0.f, sum_b = 0.f;
  const bool chunk_dp = err.kind != QT_NONE;
  float amax_a = 0.f, amax_b = 0.f;  // max |dO| of the thread's rows
  bool have_amax = false;

  // Q and dO in the first copy group
  load_tile<D, BQ, NTHREADS>(q_s, q + bh * g.S * D, q0, g.S, tid);
  load_tile<D, BQ, NTHREADS>(do_s, dO + bh * g.S * D, q0, g.S, tid);
  for (int j = 0; j < NSTAGE - 1; ++j) issue(j);
  for (int j = 0; j < n_tiles; ++j) {
    arrive();
    issue(j + NSTAGE - 1);
    const int k0 = j * BK;
    if (k0 >= wg_kend) continue;
    const uint32_t k_st = stage(j), v_st = stage(j) + L::KV_BYTES;
    float s[NS], dp[NS];
    dot_tile<D>(s, desc_q, [&](int kk) { return kmajor_desc<BK>(k_st, kk); },
                false);
    dot_tile<D>(dp, desc_do,
                [&](int kk) { return kmajor_desc<BK>(v_st, kk); }, chunk_dp);
    if (chunk_dp) {
      const uint8_t* do_t = smem_raw + (do_s - base);
      const uint8_t* v_t = smem_raw + (v_st - base);
      if (!have_amax) {
        amax_a = row_amax<BQ>(do_t, row_a, 0, D / 8);
        amax_b = row_amax<BQ>(do_t, row_a + 8, 0, D / 8);
        have_amax = true;
      }
      {  // the tile's key maxima, two threads a key
        const int t = tid & 127, key = t >> 1, half = t & 1;
        float m = row_amax<BK>(v_t, key, half * (D / 16), (half + 1) * (D / 16));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        if (!half) amax_k[wg * BK + key] = m;
        wg_barrier(wg);
      }
      settle_midpoints(
          dp, err,
          [&](int i, float d) {
            return dot_error_bound<D>(
                row_b(i) ? amax_b : amax_a,
                amax_k[wg * BK + 8 * (i >> 2) + col0 + (i & 1)], d);
          },
          [&](int i, int leader) {
            // the leader's row and column (wgmma_tile.cuh's fragment)
            const int r = wg * 64 + ((tid & 127) >> 5) * 16 + (leader >> 2);
            return warp_exact_dot<D, BQ, BK>(
                do_t, r + 8 * row_b(i), v_t,
                8 * (i >> 2) + 2 * (leader & 3) + (i & 1), lane);
          },
          lane);
    }
    if (edge(k0))
      row_probs<true>(s, g.scale, lse_a, lse_b, k0, col0, g.q_offset + ra, g);
    else
      row_probs<false>(s, g.scale, lse_a, lse_b, k0, col0, g.q_offset + ra, g);
    err_tap(dp, err);
    if constexpr (DQ) {
      // ds = p * (dp - di) * scale, rounded to bf16 as dS K's A operand
#pragma unroll
      for (int i = 0; i < NS; ++i)
        dp[i] = s[i] * (dp[i] - (row_b(i) ? di_b : di_a)) * g.scale;
      uint32_t a[BK / 16][4];
      pack_frag(a, dp);
      fence_regs(a);
      fence_regs(acc);
      wg_fence();
      wgmma_rs_tile<BK>(acc, a, k_st);
      wg_commit_wait();
      fence_regs(a);
      fence_regs(acc);
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (row_b(i)) sum_b += s[i] * dp[i];
        else sum_a += s[i] * dp[i];
      }
    }
  }

  cp_async_wait<0>();  // no copy outlives the block
  if constexpr (DQ) {
    store_rows(dq + bh * g.S * D, acc, ra, g.S, col0);
  } else {
    sum_a = quad_sum(sum_a);
    sum_b = quad_sum(sum_b);
    if ((lane & 3) == 0) {
      if (ra < g.S) di_out[bh * g.S + ra] = sum_a;
      if (rb < g.S) di_out[bh * g.S + rb] = sum_b;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_cols(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const uint16_t* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ di,
               uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
               Geometry g, QtFormat p_fmt, QtFormat err) {
  using L = ColLayout<D>;
  constexpr int NO = D / 8 * 4;  // dk (and dv) elements per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + L::KV_BYTES;
  const uint32_t qd_s = v_s + L::KV_BYTES;                // Q, dO ring
  const uint32_t rows_s = qd_s + NSTAGE * L::STAGE_BYTES;  // lse, di ring
  const float* rows_p = reinterpret_cast<const float*>(smem_raw + (rows_s - base));
  float* amax_q = reinterpret_cast<float*>(
      smem_raw + (rows_s + NSTAGE * L::ROWS_BYTES - base));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int h = blockIdx.x % g.H;
  const int b = blockIdx.x / g.H;
  const int k0 = blockIdx.y * BKV;  // key tile 0 sees the most query tiles
  const int kvh = h / (g.H / g.KV);
  const size_t bh = static_cast<size_t>(b) * g.H + h;
  const size_t bkv = static_cast<size_t>(b) * g.KV + kvh;
  const uint16_t* qp = q + bh * g.S * D;
  const uint16_t* dop = dO + bh * g.S * D;
  const float* lsep = lse + bh * g.S;
  const float* dip = di + bh * g.S;

  // this thread's keys (a, and b = a + 8) in the block
  const int row_a = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int key_a = k0 + row_a;
  const int wg_k0 = k0 + wg * 64;

  // the query tiles from the first that sees a key of the block
  const int qstart = g.causal ? max(0, k0 - g.q_offset) / BQT * BQT : 0;
  const int n_tiles = qstart < g.S ? (g.S - qstart + BQT - 1) / BQT : 0;

  auto stage = [&](int j) { return qd_s + (j % NSTAGE) * L::STAGE_BYTES; };
  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int q0 = qstart + j * BQT;
      load_tile<D, BQT, NTHREADS>(stage(j), qp, q0, g.S, tid);
      load_tile<D, BQT, NTHREADS>(stage(j) + L::Q_BYTES, dop, q0, g.S, tid);
      if (tid < 2 * BQT) {  // lse, then di, of the tile's queries
        const int c = tid % BQT;
        const bool ok = q0 + c < g.S;
        cp_async4(rows_s + (j % NSTAGE) * L::ROWS_BYTES + tid * 4,
                  (tid < BQT ? lsep : dip) + (ok ? q0 + c : 0), ok);
      }
    }
    cp_async_commit();
  };
  auto arrive = [&]() {
    cp_async_wait<NSTAGE - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  };
  auto desc_k = [&](int kk) {
    return kmajor_desc<BKV>(k_s + wg * (64 * ROW_BYTES), kk);
  };
  auto desc_v = [&](int kk) {
    return kmajor_desc<BKV>(v_s + wg * (64 * ROW_BYTES), kk);
  };

  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const bool round_p = p_fmt.kind != QT_NONE;  // s is then chunked
  const bool chunk_dp = err.kind != QT_NONE;
  float amax_a = 0.f, amax_b = 0.f;  // max |V| of the thread's keys
  bool have_amax = false;

  // K and V in the first copy group
  load_tile<D, BKV, NTHREADS>(k_s, k + bkv * g.T * D, k0, g.T, tid);
  load_tile<D, BKV, NTHREADS>(v_s, v + bkv * g.T * D, k0, g.T, tid);
  for (int j = 0; j < NSTAGE - 1; ++j) issue(j);
  for (int j = 0; j < n_tiles; ++j) {
    arrive();
    issue(j + NSTAGE - 1);
    const int q0 = qstart + j * BQT;
    // keys past T, or a tile no query of which sees the warpgroup's keys
    if (wg_k0 >= g.T || (g.causal && g.q_offset + q0 + BQT - 1 < wg_k0))
      continue;
    const uint32_t q_st = stage(j), do_st = stage(j) + L::Q_BYTES;
    const float* lse_t = rows_p + (j % NSTAGE) * (2 * BQT);
    const float* di_t = lse_t + BQT;
    float s[NC], dp[NC];
    dot_tile<D>(s, desc_k, [&](int kk) { return kmajor_desc<BQT>(q_st, kk); },
                round_p);
    dot_tile<D>(dp, desc_v,
                [&](int kk) { return kmajor_desc<BQT>(do_st, kk); }, chunk_dp);
    if (chunk_dp) {
      const uint8_t* v_t = smem_raw + (v_s - base);
      const uint8_t* do_t = smem_raw + (do_st - base);
      if (!have_amax) {
        amax_a = row_amax<BKV>(v_t, row_a, 0, D / 8);
        amax_b = row_amax<BKV>(v_t, row_a + 8, 0, D / 8);
        have_amax = true;
      }
      {  // the tile's query maxima, four threads a query
        const int t = tid & 127, qr = t >> 2, part = t & 3;
        float m = row_amax<BQT>(do_t, qr, part * (D / 32), (part + 1) * (D / 32));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (!part) amax_q[wg * BQT + qr] = m;
        wg_barrier(wg);
      }
      settle_midpoints(
          dp, err,
          [&](int i, float d) {
            return dot_error_bound<D>(
                row_b(i) ? amax_b : amax_a,
                amax_q[wg * BQT + 8 * (i >> 2) + col0 + (i & 1)], d);
          },
          [&](int i, int leader) {
            const int r = wg * 64 + ((tid & 127) >> 5) * 16 + (leader >> 2);
            return warp_exact_dot<D, BKV, BQT>(
                v_t, r + 8 * row_b(i), do_t,
                8 * (i >> 2) + 2 * (leader & 3) + (i & 1), lane);
          },
          lane);
    }
    const bool edge = q0 + BQT > g.S || wg_k0 + 64 > g.T ||
                      (g.causal && wg_k0 + 63 > g.q_offset + q0);
    if (edge) col_probs<true>(s, g.scale, lse_t, q0, col0, key_a, g);
    else col_probs<false>(s, g.scale, lse_t, q0, col0, key_a, g);
    // the dv operand: round(bf16(p)), or bf16(p)
    uint32_t a_p[BQT / 16][4], a_ds[BQT / 16][4];
    if (round_p) {
      float pv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) pv[i] = round_bf16(s[i]);
      round_frag(pv, p_fmt);
      pack_frag(a_p, pv);
    } else {
      pack_frag(a_p, s);
    }
    err_tap(dp, err);
    // ds = p * (dp - di) * scale, rounded to bf16 as dS^T Q's A operand
#pragma unroll
    for (int i = 0; i < NC; ++i)
      dp[i] = s[i] * (dp[i] - di_t[8 * (i >> 2) + col0 + (i & 1)]) * g.scale;
    pack_frag(a_ds, dp);
    fence_regs(a_p);
    fence_regs(a_ds);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
    wgmma_rs_tile<BQT>(dv_acc, a_p, do_st);
    wgmma_rs_tile<BQT>(dk_acc, a_ds, q_st);
    wg_commit_wait();
    fence_regs(a_p);
    fence_regs(a_ds);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }

  cp_async_wait<0>();  // no copy outlives the block (n_tiles may be 0)
  store_rows(dk + bh * g.T * D, dk_acc, key_a, g.T, col0);
  store_rows(dv + bh * g.T * D, dv_acc, key_a, g.T, col0);
}

// the tiles exceed the 48 KB a block gets without asking
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D, bool DQ>
int launch_rows(const void* q, const void* k, const void* v, const void* dO,
                const void* lse, const float* di_in, float* di_out,
                uint16_t* dq_out, int B, const Geometry& g, QtFormat err,
                void* stream) {
  auto kern = flash_bwd_rows<D, DQ>;
  constexpr int smem = RowLayout<D>::SMEM_BYTES;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * g.H, (g.S + BQ - 1) / BQ);
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dO),
      static_cast<const float*>(lse), di_in, di_out, dq_out, g, err);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_cols(const void* q, const void* k, const void* v, const void* dO,
                const void* lse, const void* di, void* dk, void* dv, int B,
                const Geometry& g, QtFormat p_fmt, QtFormat err,
                void* stream) {
  auto kern = flash_bwd_cols<D>;
  constexpr int smem = ColLayout<D>::SMEM_BYTES;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * g.H, (g.T + BKV - 1) / BKV);
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), g, p_fmt, err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dO (B, H, S, D) and k, v (B, KV, T, D): contiguous bf16, 16-byte
// aligned; lse (and di) f32 (B, H, S); H % KV == 0; D in {64, 128}.
// err: the dp tap's format (kind QT_NONE: none).

int flash_bwd_di(const void* q, const void* k, const void* v, const void* dO,
                 const void* lse, void* di, int B, int H, int KV, int S, int T,
                 int D, float scale, int causal, int q_offset, QtFormat err,
                 void* stream) {
  const Geometry g{H, KV, S, T, scale, causal, q_offset};
  float* di_out = static_cast<float*>(di);
  if (D == 128)
    return launch_rows<128, false>(q, k, v, dO, lse, nullptr, di_out, nullptr,
                                   B, g, err, stream);
  if (D == 64)
    return launch_rows<64, false>(q, k, v, dO, lse, nullptr, di_out, nullptr,
                                  B, g, err, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                 const void* lse, const void* di, void* dq, int B, int H,
                 int KV, int S, int T, int D, float scale, int causal,
                 int q_offset, QtFormat err, void* stream) {
  const Geometry g{H, KV, S, T, scale, causal, q_offset};
  const float* di_in = static_cast<const float*>(di);
  uint16_t* dq_out = static_cast<uint16_t*>(dq);
  if (D == 128)
    return launch_rows<128, true>(q, k, v, dO, lse, di_in, nullptr, dq_out, B,
                                  g, err, stream);
  if (D == 64)
    return launch_rows<64, true>(q, k, v, dO, lse, di_in, nullptr, dq_out, B,
                                 g, err, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dk, dv: bf16 (B, H, T, D), per query head.  p_fmt: the dv operand's
// rounding (kind QT_NONE: bf16(p)).
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                  const void* lse, const void* di, void* dk, void* dv, int B,
                  int H, int KV, int S, int T, int D, float scale, int causal,
                  int q_offset, QtFormat p_fmt, QtFormat err, void* stream) {
  const Geometry g{H, KV, S, T, scale, causal, q_offset};
  if (D == 128)
    return launch_cols<128>(q, k, v, dO, lse, di, dk, dv, B, g, p_fmt, err,
                            stream);
  if (D == 64)
    return launch_cols<64>(q, k, v, dO, lse, di, dk, dv, B, g, p_fmt, err,
                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
