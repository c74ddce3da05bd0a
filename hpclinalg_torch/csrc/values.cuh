// Value types of the SpMV kernels K1 (csrc/dia_spmv.cu), K2
// (csrc/ell_spmv.cu) and K3 (csrc/ell_resident_spmv.cu): float, double and
// the complex c64 / c128 in PyTorch's interleaved layout (the layout of
// torch.view_as_real: re, then im; c64 is 8 bytes, c128 one whole 16-byte
// unit). Each kernel is written once over T; the overloads below give it
// the loads, the multiply-add, the warp shuffles and the atomics of each
// type, so no kernel tells the types apart by their size (c64 is as wide as
// double).
//
// A complex product (a + ib)(c + id) is added as four FMAs into separate
// re and im accumulators: re += a c, re -= b d, im += a d, im += b c.

#pragma once

#include <cuda_runtime.h>

struct __align__(8) c64 {
  float re, im;
  c64() = default;
  __host__ __device__ constexpr c64(float r, float i = 0.f) : re(r), im(i) {}
};

struct __align__(16) c128 {
  double re, im;
  c128() = default;
  __host__ __device__ constexpr c128(double r, double i = 0.0)
      : re(r), im(i) {}
};

static_assert(sizeof(c64) == 8 && sizeof(c128) == 16,
              "complex values are torch's interleaved (re, im) pairs");

// entries of T in one 16-byte unit: 4 f32, 2 f64, 2 c64, 1 c128
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// ---- one entry through the read-only cache (a c128 is one 16-byte load) --
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ldg1(const double* p) { return __ldg(p); }
__device__ __forceinline__ c64 ldg1(const c64* p) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  return c64(q.x, q.y);
}
__device__ __forceinline__ c128 ldg1(const c128* p) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  return c128(q.x, q.y);
}

// ---- one 16-byte unit of entries through the read-only cache -------------
__device__ __forceinline__ void ldg16(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ldg16(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void ldg16(const c64* p, c64 (&v)[2]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = c64(q.x, q.y); v[1] = c64(q.z, q.w);
}
__device__ __forceinline__ void ldg16(const c128* p, c128 (&v)[1]) {
  v[0] = ldg1(p);
}

// ---- arithmetic -----------------------------------------------------------
__device__ __forceinline__ c64 operator+(c64 a, c64 b) {
  return c64(a.re + b.re, a.im + b.im);
}
__device__ __forceinline__ c128 operator+(c128 a, c128 b) {
  return c128(a.re + b.re, a.im + b.im);
}

// acc + a * b: the real kernels' expression as it always was (the compiler
// contracts it into one FMA); complex as four FMAs
__device__ __forceinline__ float mad(float acc, float a, float b) {
  return acc + a * b;
}
__device__ __forceinline__ double mad(double acc, double a, double b) {
  return acc + a * b;
}
__device__ __forceinline__ c64 mad(c64 acc, c64 a, c64 b) {
  acc.re = fmaf(a.re, b.re, acc.re);
  acc.re = fmaf(-a.im, b.im, acc.re);
  acc.im = fmaf(a.re, b.im, acc.im);
  acc.im = fmaf(a.im, b.re, acc.im);
  return acc;
}
__device__ __forceinline__ c128 mad(c128 acc, c128 a, c128 b) {
  acc.re = fma(a.re, b.re, acc.re);
  acc.re = fma(-a.im, b.im, acc.re);
  acc.im = fma(a.re, b.im, acc.im);
  acc.im = fma(a.im, b.re, acc.im);
  return acc;
}

// a * b
__device__ __forceinline__ float mul(float a, float b) { return a * b; }
__device__ __forceinline__ double mul(double a, double b) { return a * b; }
__device__ __forceinline__ c64 mul(c64 a, c64 b) { return mad(c64(0.f), a, b); }
__device__ __forceinline__ c128 mul(c128 a, c128 b) {
  return mad(c128(0.0), a, b);
}

// ---- warp shuffles, each component on its own ------------------------------
constexpr unsigned kFull = 0xffffffffu;

template <typename R>
__device__ __forceinline__ R shfl_xor(R v, int o) {
  return __shfl_xor_sync(kFull, v, o);
}
template <>
__device__ __forceinline__ c64 shfl_xor<c64>(c64 v, int o) {
  return c64(__shfl_xor_sync(kFull, v.re, o), __shfl_xor_sync(kFull, v.im, o));
}
template <>
__device__ __forceinline__ c128 shfl_xor<c128>(c128 v, int o) {
  return c128(__shfl_xor_sync(kFull, v.re, o),
              __shfl_xor_sync(kFull, v.im, o));
}

template <typename R>
__device__ __forceinline__ R shfl_up(R v, int o) {
  return __shfl_up_sync(kFull, v, o);
}
template <>
__device__ __forceinline__ c64 shfl_up<c64>(c64 v, int o) {
  return c64(__shfl_up_sync(kFull, v.re, o), __shfl_up_sync(kFull, v.im, o));
}
template <>
__device__ __forceinline__ c128 shfl_up<c128>(c128 v, int o) {
  return c128(__shfl_up_sync(kFull, v.re, o), __shfl_up_sync(kFull, v.im, o));
}

// ---- atomics: there is no complex atomicAdd, so one a component -----------
__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(double* p, double v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(c64* p, c64 v) {
  atomicAdd(&p->re, v.re);
  atomicAdd(&p->im, v.im);
}
__device__ __forceinline__ void atomic_add(c128* p, c128 v) {
  atomicAdd(&p->re, v.re);
  atomicAdd(&p->im, v.im);
}
