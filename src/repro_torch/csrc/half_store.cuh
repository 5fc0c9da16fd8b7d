// The storage types of the two band kernels (csrc/rotseq_wave.cu,
// csrc/rotseq_batched.cu) and their half-precision plane pair, included by
// both.  kernels/_build.py hashes this header into the library's name with
// the sources, and tests/test_torch_half_batched.py and
// tests/test_torch_wave.py walk it on the CPU (tests/_torch_half_bits.py).
//
// Half precision (bfloat16, float16), as eager PyTorch computes on half
// tensors: each float32 product and sum of a plane is rounded to the half
// type before the next one uses it, 7 roundings a plane (4 products, the
// difference and the two results).  A conversion (F2F or F2FP) issues at
// 16 lanes a clock an SM, ~8 cycles a warp, so rounded one at a time they
// set a half plane's pace.  The band kernels therefore:
//   - keep their register window in float32, every value in it exactly
//     representable in T (it was rounded when it was made): a column is
//     widened once when it enters the window (Store<T>::w) and narrowed
//     once, exactly, when it leaves (Store<T>::n); the pair keeps every
//     bit, a NaN's payload too;
//   - round in pairs: planes i and i+1 of a step are independent, so
//     each of their 7 roundings is one paired instruction for the two.
//     The sum, the difference and g's product take two values already in
//     T: one native paired op each (__hadd2, __hsub2, __hmul2), which
//     rounds the exact result to T once.  That equals eager PyTorch's
//     float32 op then rounding: a product of two T values is exact in
//     float32 (bfloat16's 16 bits, float16's 22; a bfloat16 product finer
//     than float32's last place lies below half bfloat16's least
//     subnormal, where both give 0), and float32's 24 bits are at least
//     2p + 2 for T's p (8, 11), so a sum or difference rounded twice
//     equals it rounded once (Figueroa, "When is double rounding
//     innocuous?", 1995).  The 4 products are two T values too, spelled
//     two ways:
//       plane_pair (the fused kernel's): float32 products of the window's
//         values and the widened c or s, one packed conversion each
//         (Store<T>::p2, cvt.rn.bf16x2.f32 / cvt.rn.f16x2.f32: one F2FP,
//         2 a plane);
//       plane_pair_native (the wavefront kernel's): a native __hmul2 each
//         of the paired window values (Store<T>::pair: bfloat16 by a byte
//         permute of their upper halves, float16 by one exact F2FP for
//         the two) and c or s staged as raw T bits: no conversion a plane
//         in bfloat16, 1 in float16, and 13% faster than plane_pair in
//         the wavefront kernel at the paper shape on an H100
//         (tools/wave_half_ab.py).
//     Only the two results are widened into the window (bfloat16: a shift
//     and a mask; float16: HADD2.F32), and g (with c and s, for
//     plane_pair_native) is staged as its raw bits and paired by a byte
//     permute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

// The storage type T of the operand and its conversions.  f widens a
// panel value to float32 (exact, as eager PyTorch widens it); w widens a
// column into the window and n narrows a window value back (exact for a
// T-exact value, and the two keep every bit, a NaN's payload too); all
// three are the identity for float.  In half precision P2 holds the same
// value of two planes: p2 rounds two float32 values to T to nearest even
// in one packed conversion (a low, b high), w2 widens a pair back, bits
// pairs two values staged as raw T bits and pair two T-exact float32
// values (both exact); kOne is the raw bits of 1 in T (-1 with the sign
// bit set).
template <typename T>
struct Store;

template <>
struct Store<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float w(float v) { return v; }
  static __device__ __forceinline__ float n(float v) { return v; }
};

template <>
struct Store<__nv_bfloat16> {
  using P2 = __nv_bfloat162;
  static constexpr unsigned kOne = 0x3F80u;
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float w(__nv_bfloat16 v) {
    return __bfloat162float(v);                 // the bits, shifted up
  }
  static __device__ __forceinline__ __nv_bfloat16 n(float v) {
    return __ushort_as_bfloat16(
        static_cast<unsigned short>(__float_as_uint(v) >> 16));
  }
  static __device__ __forceinline__ P2 p2(float a, float b) {
    return __floats2bfloat162_rn(a, b);         // cvt.rn.bf16x2.f32
  }
  static __device__ __forceinline__ float2 w2(P2 p) {
    const unsigned u = *reinterpret_cast<const unsigned*>(&p);
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xFFFF0000u));
  }
  static __device__ __forceinline__ P2 bits(float a, float b) {
    const unsigned u =
        __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x5410);
    return *reinterpret_cast<const P2*>(&u);
  }
  static __device__ __forceinline__ P2 pair(float a, float b) {
    const unsigned u =                          // the upper halves
        __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
    return *reinterpret_cast<const P2*>(&u);
  }
};

template <>
struct Store<__half> {
  using P2 = __half2;
  static constexpr unsigned kOne = 0x3C00u;
  static __device__ __forceinline__ float f(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ float w(__half v) {
    const unsigned h = __half_as_ushort(v);
    if ((h & 0x7FFFu) > 0x7C00u) {              // NaN: keep sign and payload
      return __uint_as_float(((h & 0x8000u) << 16) | 0x7F800000u |
                             ((h & 0x3FFu) << 13));
    }
    return __half2float(v);
  }
  static __device__ __forceinline__ __half n(float v) {
    const unsigned u = __float_as_uint(v);
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) {      // NaN: w's inverse
      return __ushort_as_half(static_cast<unsigned short>(
          ((u >> 16) & 0x8000u) | 0x7C00u | ((u >> 13) & 0x3FFu)));
    }
    return __float2half_rn(v);                  // exact: v is T-exact
  }
  static __device__ __forceinline__ P2 p2(float a, float b) {
    return __floats2half2_rn(a, b);             // cvt.rn.f16x2.f32
  }
  static __device__ __forceinline__ float2 w2(P2 p) {
    return __half22float2(p);
  }
  static __device__ __forceinline__ P2 pair(float a, float b) {
    return __floats2half2_rn(a, b);             // exact: a, b T-exact
  }
  static __device__ __forceinline__ P2 bits(float a, float b) {
    const unsigned u =
        __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x5410);
    return *reinterpret_cast<const P2*>(&u);
  }
};

// Two planes of one step in half precision, on disjoint columns: plane 0
// maps (x0, y0), plane 1 (x1, y1), each q = {c, s, g's raw T bits, -} with
// c and s widened to float32, every x, y T-exact.  Each product, the
// difference and both results of the two are rounded to T together, in the
// order of repro_torch.core.rotations.plane_update; xn = (x0', x1') and
// yn = (y0', y1'), T-exact in float32.
template <typename T>
__device__ __forceinline__ void plane_pair(const float4& q0, const float4& q1,
                                           float x0, float y0, float x1,
                                           float y1, float2& xn,
                                           float2& yn) {
  using St = Store<T>;
  using P2 = typename St::P2;
  const P2 cx = St::p2(__fmul_rn(q0.x, x0), __fmul_rn(q1.x, x1));
  const P2 sy = St::p2(__fmul_rn(q0.y, y0), __fmul_rn(q1.y, y1));
  const P2 sx = St::p2(__fmul_rn(q0.y, x0), __fmul_rn(q1.y, x1));
  const P2 cy = St::p2(__fmul_rn(q0.x, y0), __fmul_rn(q1.x, y1));
  const P2 g = St::bits(q0.z, q1.z);
  const P2 xs = __hadd2(cx, sy);
  const P2 d = __hsub2(sx, cy);
  const P2 ys = __hmul2(g, d);
  xn = St::w2(xs);
  yn = St::w2(ys);
}

// plane_pair with every product a native paired op of two T values: q =
// {c, s, g, -} all as raw T bits; the same results, bit for bit.
template <typename T>
__device__ __forceinline__ void plane_pair_native(const float4& q0,
                                                  const float4& q1, float x0,
                                                  float y0, float x1,
                                                  float y1, float2& xn,
                                                  float2& yn) {
  using St = Store<T>;
  using P2 = typename St::P2;
  const P2 c = St::bits(q0.x, q1.x);
  const P2 s = St::bits(q0.y, q1.y);
  const P2 x = St::pair(x0, x1);
  const P2 y = St::pair(y0, y1);
  const P2 cx = __hmul2(c, x);
  const P2 sy = __hmul2(s, y);
  const P2 sx = __hmul2(s, x);
  const P2 cy = __hmul2(c, y);
  const P2 g = St::bits(q0.z, q1.z);
  const P2 xs = __hadd2(cx, sy);
  const P2 d = __hsub2(sx, cy);
  const P2 ys = __hmul2(g, d);
  xn = St::w2(xs);
  yn = St::w2(ys);
}

}  // namespace
