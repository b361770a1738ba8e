// Elementwise direct rounding of a contiguous tensor (bf16 or f32 in, the
// same dtype out) to one of the formats of qt_round.cuh.
//
// Replaces quantized_training_tpu/ops/pallas/quantize_elemwise.py:30
// (_kernel, reached through pallas_quantize).  The TPU kernel tiles a
// flattened (rows, 1024) view and falls back to XLA when the size does not
// tile; here any size is taken and the ragged tail is masked.
//
// Every kind of qt_round.cuh: posit, fp8, fpN, int, the NormalFloat
// codebooks (the search compares in the input's dtype, so bf16 and f32
// inputs take separate instantiations) and the native bf16 / f16 casts.
//
// What bounds it on an H100: bytes, one read and one write of the tensor at
// 3.35 TB/s.  Two forms:
//
//   * Table (bf16 input, quantize_elemwise_table): any rounding of a bf16
//     value is a function of its 16 bits, so qt_table_build runs qt_round
//     over all 2^16 patterns once per (device, format) into a 128 KB table
//     (the wrapper caches it), and the streaming kernel does one
//     shared-memory lookup an element.  Its grid is persistent, at most one
//     block an SM (the table fills 128 KB of a block's shared memory): one
//     thread issues the table's bulk copies (cp.async.bulk, completed on
//     an mbarrier) while every thread's first four 16-byte loads are in
//     flight; then each thread issues its next four loads before it looks
//     up and stores the current ones.  Bank conflicts do not bind: a
//     warp-wide lookup of a 7B-like Gaussian weight's bf16 patterns meets
//     3.4 distinct words a bank on average (all patterns 4.0, a constant
//     1.0), and the three time alike on an H100, at a copy's rate.  The
//     first form spent about 16 conversions an element on a codebook
//     search and ~25 operations on a posit rounding, switched on the
//     format per element.
//   * Arithmetic (f32 input, and bf16 tensors too small to pay for the
//     table's fill, ops/quantize_elemwise.py:elemwise_form): qt_round per
//     element, the format's kind a template argument (qt_round_each's
//     pattern: one instantiation a kind, no per-element switch), 16 bytes
//     a thread per load and store in a grid-stride loop.
//
// A tensor whose pointers are not 16-byte aligned takes each form's scalar
// loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qt_round.cuh"
#include "tma_pipe.cuh"

namespace {

constexpr int THREADS = 256;          // arithmetic form
constexpr int T_THREADS = 1024;       // table form
constexpr int T_UNROLL = 4;           // 16-byte loads a thread a round
constexpr int TABLE_ENTRIES = 1 << 16;
constexpr int TABLE_BYTES = TABLE_ENTRIES * 2;
constexpr int TABLE_COPIES = 4;       // bulk copies that fill it
constexpr int T_SMEM = TABLE_BYTES + 16;  // the table, then its mbarrier

// ---- table form -----------------------------------------------------------------
// table[i] = the bf16 bits of qt_round<true>(bf16 pattern i): the arithmetic
// form's value bit for bit
__global__ void qt_table_build(uint16_t* __restrict__ table, QtFormat f) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < TABLE_ENTRIES) {
    const float v = qt_round<true>(__uint_as_float(static_cast<uint32_t>(i) << 16), f);
    table[i] = static_cast<uint16_t>(__float_as_uint(v) >> 16);
  }
}

// two bf16 values of a 32-bit word, each looked up
__device__ __forceinline__ uint32_t look2(const uint16_t* tab, uint32_t w) {
  return __byte_perm(tab[w & 0xffffu], tab[w >> 16], 0x5410u);
}

__device__ __forceinline__ void load_round(uint4 (&buf)[T_UNROLL], const uint4* x,
                                           int64_t i, int64_t nv) {
#pragma unroll
  for (int u = 0; u < T_UNROLL; ++u) {
    const int64_t k = i + static_cast<int64_t>(u) * T_THREADS;
    if (k < nv) buf[u] = x[k];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(T_THREADS, 1)
round_table_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ y,
                   int64_t n, const uint16_t* __restrict__ table) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t bar = base + TABLE_BYTES;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_expect_tx(bar, TABLE_BYTES);
    constexpr int piece = TABLE_BYTES / TABLE_COPIES;
#pragma unroll
    for (int c = 0; c < TABLE_COPIES; ++c)
      tma_load_1d(base + c * piece, reinterpret_cast<const uint8_t*>(table) + c * piece,
                  piece, bar);
  }
  if (VEC) {
    const auto* xv = reinterpret_cast<const uint4*>(x);
    auto* yv = reinterpret_cast<uint4*>(y);
    const int64_t nv = n / 8;
    const int64_t step = static_cast<int64_t>(gridDim.x) * T_THREADS * T_UNROLL;
    int64_t i = static_cast<int64_t>(blockIdx.x) * T_THREADS * T_UNROLL + threadIdx.x;
    uint4 cur[T_UNROLL];
    load_round(cur, xv, i, nv);  // in flight while the table lands
    __syncthreads();             // the barrier initialized before any wait
    mbar_wait(bar, 0);
    for (; i < nv; i += step) {
      uint4 nxt[T_UNROLL];
      load_round(nxt, xv, i + step, nv);
#pragma unroll
      for (int u = 0; u < T_UNROLL; ++u) {
        const int64_t k = i + static_cast<int64_t>(u) * T_THREADS;
        if (k < nv) {
          const uint4 w = cur[u];
          yv[k] = make_uint4(look2(tab, w.x), look2(tab, w.y), look2(tab, w.z),
                             look2(tab, w.w));
        }
        cur[u] = nxt[u];
      }
    }
    // the ragged tail: fewer than 8 elements
    const int64_t t = nv * 8 + static_cast<int64_t>(blockIdx.x) * T_THREADS + threadIdx.x;
    if (t < n) y[t] = tab[x[t]];
  } else {
    __syncthreads();
    mbar_wait(bar, 0);
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * T_THREADS + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * T_THREADS)
      y[i] = tab[x[i]];
  }
}

// ---- arithmetic form ------------------------------------------------------------
template <bool BF16, int KIND, bool VEC>
__global__ void __launch_bounds__(THREADS)
round_arith_kernel(const void* __restrict__ xv, void* __restrict__ yv, int64_t n,
                   QtFormat f) {
  f.kind = KIND;  // qt_round's switch folds to this kind
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (BF16) {
    const auto* x = static_cast<const uint16_t*>(xv);
    auto* y = static_cast<uint16_t*>(yv);
    int64_t start = 0;
    if (VEC) {
      const int64_t nv = n / 8;
      for (int64_t i = tid; i < nv; i += stride) {
        uint4 w = reinterpret_cast<const uint4*>(x)[i];
        uint32_t* p = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = qt_round<true>(__uint_as_float(p[e] << 16), f);
          const float hi = qt_round<true>(__uint_as_float(p[e] & 0xffff0000u), f);
          p[e] = (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
        }
        reinterpret_cast<uint4*>(y)[i] = w;
      }
      start = nv * 8;
    }
    for (int64_t i = start + tid; i < n; i += stride) {
      const float v = qt_round<true>(__uint_as_float(static_cast<uint32_t>(x[i]) << 16), f);
      y[i] = static_cast<uint16_t>(__float_as_uint(v) >> 16);
    }
  } else {
    const auto* x = static_cast<const float*>(xv);
    auto* y = static_cast<float*>(yv);
    int64_t start = 0;
    if (VEC) {
      const int64_t nv = n / 4;
      for (int64_t i = tid; i < nv; i += stride) {
        float4 w = reinterpret_cast<const float4*>(x)[i];
        w.x = qt_round<false>(w.x, f);
        w.y = qt_round<false>(w.y, f);
        w.z = qt_round<false>(w.z, f);
        w.w = qt_round<false>(w.w, f);
        reinterpret_cast<float4*>(y)[i] = w;
      }
      start = nv * 4;
    }
    for (int64_t i = start + tid; i < n; i += stride) y[i] = qt_round<false>(x[i], f);
  }
}

template <bool BF16, int KIND>
void launch_arith(const void* x, void* y, int64_t n, const QtFormat& f, bool vec,
                  int sms, cudaStream_t st) {
  const int64_t per_thread = vec ? (BF16 ? 8 : 4) : 1;
  int64_t blocks = (n / per_thread + THREADS - 1) / THREADS;
  blocks = blocks < 1 ? 1 : (blocks > sms * 16 ? sms * 16 : blocks);
  if (vec)
    round_arith_kernel<BF16, KIND, true><<<static_cast<int>(blocks), THREADS, 0, st>>>(x, y, n, f);
  else
    round_arith_kernel<BF16, KIND, false><<<static_cast<int>(blocks), THREADS, 0, st>>>(x, y, n, f);
}

template <bool BF16>
cudaError_t launch_kind(const void* x, void* y, int64_t n, const QtFormat& f, bool vec,
                        int sms, cudaStream_t st) {
  switch (f.kind) {
    case QT_NONE: launch_arith<BF16, QT_NONE>(x, y, n, f, vec, sms, st); break;
    case QT_POSIT: launch_arith<BF16, QT_POSIT>(x, y, n, f, vec, sms, st); break;
    case QT_FP8: launch_arith<BF16, QT_FP8>(x, y, n, f, vec, sms, st); break;
    case QT_FP: launch_arith<BF16, QT_FP>(x, y, n, f, vec, sms, st); break;
    case QT_INT: launch_arith<BF16, QT_INT>(x, y, n, f, vec, sms, st); break;
    case QT_NF: launch_arith<BF16, QT_NF>(x, y, n, f, vec, sms, st); break;
    case QT_CAST: launch_arith<BF16, QT_CAST>(x, y, n, f, vec, sms, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

extern "C" {

const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The arithmetic form.  x, y: n contiguous elements each, bf16 (is_bf16 =
// 1) or f32, not aliased.
int quantize_elemwise(const void* x, void* y, long long n, int is_bf16,
                      QtFormat f, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = aligned16(x) && aligned16(y);
  const int sms = device_sms();
  return static_cast<int>(is_bf16 ? launch_kind<true>(x, y, n, f, vec, sms, st)
                                  : launch_kind<false>(x, y, n, f, vec, sms, st));
}

// The table of format f for bf16 inputs: 2^16 bf16 values into `table`
// (16-byte aligned device memory).
int quantize_table_build(void* table, QtFormat f, void* stream) {
  qt_table_build<<<TABLE_ENTRIES / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(table), f);
  return static_cast<int>(cudaGetLastError());
}

// The table form.  x, y: n contiguous bf16 elements each, not aliased;
// table: quantize_table_build's output.  At most one block an SM.
int quantize_elemwise_table(const void* x, void* y, long long n,
                            const void* table, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (!aligned16(table)) return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set = false;  // the kernels' shared-memory cap, set once
  if (!smem_set) {
    using Kernel = void (*)(const uint16_t*, uint16_t*, int64_t, const uint16_t*);
    const Kernel kernels[2] = {round_table_kernel<true>, round_table_kernel<false>};
    for (const Kernel k : kernels) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    smem_set = true;
  }
  const bool vec = aligned16(x) && aligned16(y);
  const int64_t per_block = static_cast<int64_t>(T_THREADS) * (vec ? 8 * T_UNROLL : 1);
  int64_t g = (n + per_block - 1) / per_block;
  const int sms = device_sms();
  const int blocks = static_cast<int>(g > sms ? sms : g);
  const auto* xs = static_cast<const uint16_t*>(x);
  auto* ys = static_cast<uint16_t*>(y);
  const auto* ts = static_cast<const uint16_t*>(table);
  if (vec)
    round_table_kernel<true><<<blocks, T_THREADS, T_SMEM, st>>>(xs, ys, n, ts);
  else
    round_table_kernel<false><<<blocks, T_THREADS, T_SMEM, st>>>(xs, ys, n, ts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
