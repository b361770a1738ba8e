// Elementwise rounding to the package's low-precision formats, as device
// code shared by the kernels that round: quantize_elemwise.cu (alone),
// flash_attn_fwd.cu (probabilities and output) and quantized_matmul.cu (the
// A operand).  One implementation, held bit-equal to the plain PyTorch
// quantizers (quantized_training_torch/numerics/) over all 2^16 bf16
// patterns on the card.
//
//   posit(nbits, es): the single-variable-shift integer round to nearest
//     even of numerics/posit.py:quantize_to_posit_fast (bit-identical on
//     [0, 1] to the unit forms the reference uses for probabilities);
//   fp8 (E4M3 / E5M2): guard/sticky round to nearest even on the float32
//     bits, saturating (numerics/fp8.py:_quantize_fp8);
//   fp (fpN_eXmY): the generic mantissa-scaling quantizer with round half
//     to even and saturation (numerics/fp8.py:quantize_elemwise), every
//     operation rounded to the input dtype as PyTorch computes bf16 ops;
//   int / uint: round half to even, saturate.
//
// Every float add, multiply and divide is an explicit _rn intrinsic, which
// nvcc never contracts into an FMA, and f32 -> bf16 is __float2bfloat16_rn.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// Passed by value from Python (ctypes.Structure of the same layout).
struct QtFormat {
  int kind;   // QT_NONE, QT_POSIT, QT_FP8, QT_FP, QT_INT
  int a;      // posit: nbits; fp8: floor(log2(min normal)); fp: ebits; int: nbits
  int b;      // posit: es; fp8 and fp: mbits
  int flags;  // fp and int: 1 = unsigned
  float hi;   // posit: maxpos; fp8, fp: max normal; int: quant_max
  float lo;   // posit: minpos; fp8: min normal; int: quant_min
  float zero; // posit, fp8: magnitudes at or below (fp8) / below (posit) this round to 0
};

enum { QT_NONE = 0, QT_POSIT = 1, QT_FP8 = 2, QT_FP = 3, QT_INT = 4 };

__device__ __forceinline__ float qt_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int qt_clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// 1 << clamp(c, 0, 31), as int32 bits
__device__ __forceinline__ int qt_pow2i(int c) {
  return static_cast<int>(1u << qt_clampi(c, 0, 31));
}

__device__ __forceinline__ float qt_posit(float x, const QtFormat& f) {
  const int nbits = f.a, es = f.b;
  const unsigned sign_bit = __float_as_uint(x) & 0x80000000u;
  const float xa = fminf(fmaxf(fabsf(x), f.lo), f.hi);
  const int bits = __float_as_int(xa);
  const int e = (bits >> 23) - 127;
  const int run = e >= 0 ? 1 + (e >> es) : -(e >> es);
  const int s2 = qt_clampi(run + es + 25 - nbits, 0, 23 + es);
  const int q = 1 << s2;
  const int q_mask = q - 1;
  const int r = (127 << 23) & q_mask;
  const int lsb = s2 >= 23 + es ? (e < 0) : (((bits - (127 << 23)) & q) != 0);
  const int rounded = ((bits - r) + (q >> 1) - 1 + lsb) & ~q_mask;
  float out = fminf(__int_as_float(rounded + r), f.hi);
  out = __uint_as_float(__float_as_uint(out) | sign_bit);
  if (fabsf(x) < f.zero) out = 0.f;
  if (!isfinite(x)) out = __int_as_float(0x7fc00000);
  return out;
}

__device__ __forceinline__ float qt_fp8(float x, const QtFormat& f) {
  const int mbits = f.b, min_exp = f.a;
  const int raw = __float_as_int(x);
  const int exp = ((raw & 0x7f800000) >> 23) - 127;
  const int fraction = (raw & 0x7fffff) | 0x800000;
  const int nf_shift = 23 - mbits + max(min_exp - exp, 0);
  const bool lb = (fraction & qt_pow2i(nf_shift)) != 0;
  const bool gb = (fraction & qt_pow2i(nf_shift - 1)) != 0;
  const bool sb = (fraction & (qt_pow2i(nf_shift - 1) - 1)) != 0;
  const bool rb = (lb && gb) || (gb && sb);
  const int nf = qt_clampi(nf_shift, 0, 23);
  int out_bits = raw & static_cast<int>(0xffffffffu << nf);
  if (rb) out_bits += 1 << nf;
  float out = fminf(fmaxf(__int_as_float(out_bits), -f.hi), f.hi);
  if (fabsf(x) <= f.zero) out = 0.f;
  if (x == 0.f) out = 0.f;
  if (!isfinite(x)) out = __int_as_float(0x7fc00000);
  return out;
}

__device__ __forceinline__ float qt_int(float x, const QtFormat& f) {
  const float v = rintf(x);
  return v < f.lo ? f.lo : (v > f.hi ? f.hi : v);
}

// The generic fpN_eXmY quantizer; BF16: every operation's result is rounded
// to bf16, as PyTorch computes elementwise bf16 ops (in float32, rounded).
template <bool BF16>
__device__ __forceinline__ float qt_fp(float a, const QtFormat& f) {
  auto R = [](float v) { return BF16 ? qt_bf16(v) : v; };
  const int ebits = f.a, mbits = f.b;
  if (f.flags) a = fabsf(a);
  // floor(log2|a|): log2 in float32, rounded to the input dtype, floored
  const float lg = log2f(fabsf(a == 0.f ? 1.f : a));
  float pe = floorf(R(lg));
  const float min_exp = static_cast<float>(-(1 << (ebits - 1)) + 2);
  pe = fmaxf(pe, min_exp);
  const int pei = isfinite(pe) ? static_cast<int>(pe) : 0;
  const float p2 = __int_as_float(qt_clampi(pei + 127, 0, 255) << 23);
  const float c = __int_as_float((mbits + 127) << 23);  // 2^(bits-2)
  float out = R(__fmul_rn(R(__fdiv_rn(a, p2)), c));
  // round half to even on the scaled mantissa
  const float sgn = signbit(out) ? -1.f : 1.f;
  const float abs_a = fabsf(out);
  const float t = R(__fsub_rn(abs_a, 0.5f));
  const float odd_up = fmodf(t, 2.f) == 0.f ? 1.f : 0.f;
  const float fl = floorf(R(__fadd_rn(abs_a, 0.5f)));
  out = __fmul_rn(sgn, R(__fsub_rn(fl, odd_up)));
  out = R(__fmul_rn(R(__fdiv_rn(out, c)), p2));
  const float hi = R(f.hi);
  out = out < -hi ? -hi : (out > hi ? hi : out);
  if ((__float_as_uint(a) & 0x7fffffffu) == 0u) out = 0.f;
  if (isinf(a)) out = a;
  if (isnan(a)) out = __int_as_float(0x7fc00000);
  return out;
}

// Round x (an exact value of the input dtype: bf16 when BF16) to the
// format; the result is a value of the input dtype.
template <bool BF16>
__device__ __forceinline__ float qt_round(float x, const QtFormat& f) {
  float y;
  switch (f.kind) {
    case QT_POSIT: y = qt_posit(x, f); break;
    case QT_FP8: y = qt_fp8(x, f); break;
    case QT_FP: return qt_fp<BF16>(x, f);
    case QT_INT: y = qt_int(x, f); break;
    default: return x;
  }
  return BF16 ? qt_bf16(y) : y;
}
