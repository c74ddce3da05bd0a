// K1: DIA (stencil) SpMV for Hopper, all stacked shards in one launch.
//
//   y[s, i] = sum_t dval[s, t, i] * g[s, i + off_t]      (0 <= i < Lrow)
//
// where g[s, j] reads as 0 outside [0, gcols): the zero padding the JAX
// package materialises with bias_lo/bias_hi (hpclinalg/ops/spmv.py,
// _dia_exec) is a bounds mask here, so no padded copy of g is made.
//
// Replaces the TPU kernels hpclinalg/ops/pallas_dia.py::_pallas_dia_fn and
// ::_pallas_dia_fn_monolithic (and the XLA _dia_exec they stand beside).
//
// Bound: device-memory bytes, (O + 2) * Lrow * S * sizeof(T) per product:
// the table is streamed once, x and y once each. A stream is bound by the
// bytes in flight: one 4-byte load a thread moves about 1 TB/s on the H100,
// 16-byte loads with the streaming hint about 3.1 TB/s. Design:
//   * A block takes a tile of blockDim.x * 16 / sizeof(T) rows: a thread
//     holds 16 bytes of rows, as one unit of W = 16 / sizeof(T) rows
//     (dia_vec) or as W units of one row (dia_scalar), unit u at tile row
//     (u * blockDim.x + x) * W, so a warp's access is contiguous. The table
//     is read kChunk = 10 diagonals at a time: all loads of a chunk are
//     issued before the first sum (O = 5: five 16-byte loads in flight a
//     thread). Two or four units a thread, the first design, were at best
//     2 % faster and up to 7 % slower on the patterns measured (PERF.md).
//   * The table is read and y written with the streaming hint (ld/st.cs,
//     evict first: each byte is touched once), leaving L2 to the x windows
//     that neighbouring tiles read again.
//   * x is staged in shared memory: the union of the O row intervals
//     [row0 + off_t, row0 + off_t + tile), merged where they overlap and
//     widened to 16-byte ends (the pieces, computed on the host by
//     ops/cuda_dia.py dia_layout), with cp.async issued before the first
//     table loads and waited for just before x is first read, so the window
//     fill overlaps the table stream. A wide offset span stages a few pieces
//     of one tile each instead of the span; x read through __ldg instead
//     was up to 10 % slower, and on the wide pattern in f32 no faster.
//     Reads from shared memory are scalar: row + off_t is unaligned.
//   * dia_vec reads and writes 16 bytes an access (W = 16 / sizeof(T)) and
//     needs dval, g and y 16-byte aligned, Lrow and g's shard stride
//     multiples of W; dia_scalar (W = 1) takes every other table, with
//     element copies into the same window. The wrapper picks one by those
//     facts (ops/cuda_dia.py dia_kernel).
// Each real term is rounded as product, then sum (no fused multiply-add),
// in offset order: the arithmetic of the plain twin and of _dia_exec's
// body, so both kernels agree with the twin bit for bit.
//
// Complex values (c64, c128 in torch's interleaved layout, csrc/values.cuh)
// run through the same two kernels in one launch: a thread still holds 16
// bytes of rows (2 c64 rows, 1 c128 row), and each term is four FMAs into
// the row's re and im accumulators, so a complex result agrees with the
// twin to rounding, not bit for bit. A c128 row is a whole 16-byte unit, so
// dia_vec and dia_scalar walk the same rows and the wrapper runs dia_vec.

#include <cuda_runtime.h>
#include <stdint.h>

#include "values.cuh"

#define DIA_MAX_OFFSETS 64
#define DIA_THREADS 256   // a block's threads at most

// rows a thread: one 16-byte unit (dia_vec), or as many single rows
// (dia_scalar), so both kernels walk the same tiles; and the diagonals
// whose table loads a thread issues before its first sum
template <typename T>
constexpr int kRows = kVec<T>;
constexpr int kChunk = 10;

// The pattern and its window, built once per pattern by the wrapper. Piece p
// stages g[row0 + lo[p], row0 + lo[p] + len[p]) into win[base[p], + len[p]);
// diagonal t reads tile row r at win[shift[t] + r].
struct DiaLayout {
  int n;
  int npieces;
  int shift[DIA_MAX_OFFSETS];
  int lo[DIA_MAX_OFFSETS];
  int len[DIA_MAX_OFFSETS];
  int base[DIA_MAX_OFFSETS];
};

// one term acc + a*b: in reals with two roundings (the intrinsics are
// never contracted), in complex as four FMAs (values.cuh mad)
__device__ __forceinline__ float term(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ double term(double acc, double a, double b) {
  return __dadd_rn(acc, __dmul_rn(a, b));
}
__device__ __forceinline__ c64 term(c64 acc, c64 a, c64 b) {
  return mad(acc, a, b);
}
__device__ __forceinline__ c128 term(c128 acc, c128 a, c128 b) {
  return mad(acc, a, b);
}

// W elements at p, read and written with the streaming hint
__device__ __forceinline__ void ldcs(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void ldcs(const double* p, double (&v)[2]) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void ldcs(const c64* p, c64 (&v)[2]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = c64(q.x, q.y), v[1] = c64(q.z, q.w);
}
__device__ __forceinline__ void ldcs(const c64* p, c64 (&v)[1]) {
  const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
  v[0] = c64(q.x, q.y);
}
__device__ __forceinline__ void ldcs(const c128* p, c128 (&v)[1]) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = c128(q.x, q.y);
}
template <typename T>
__device__ __forceinline__ void ldcs(const T* p, T (&v)[1]) {
  v[0] = __ldcs(p);
}
__device__ __forceinline__ void stcs(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void stcs(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}
__device__ __forceinline__ void stcs(c64* p, const c64 (&v)[2]) {
  __stcs(reinterpret_cast<float4*>(p),
         make_float4(v[0].re, v[0].im, v[1].re, v[1].im));
}
__device__ __forceinline__ void stcs(c64* p, const c64 (&v)[1]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v[0].re, v[0].im));
}
__device__ __forceinline__ void stcs(c128* p, const c128 (&v)[1]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0].re, v[0].im));
}
template <typename T>
__device__ __forceinline__ void stcs(T* p, const T (&v)[1]) {
  __stcs(p, v[0]);
}

// BYTES from global to shared memory, asynchronously: 16 bytes bypass L1
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
}

template <typename T, int W>
__device__ __forceinline__ void dia_tile(const T* __restrict__ dval,
                                         const T* __restrict__ g,
                                         T* __restrict__ y, int64_t Lrow,
                                         int64_t gcols, int64_t g_stride,
                                         const DiaLayout& lay, T* win) {
  constexpr int U = kRows<T> / W;
  const int s = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.x * blockDim.x * kRows<T>;
  const T* gs = g + (int64_t)s * g_stride;
  // 1. the window's pieces, masked at the ends of g
  for (int p = 0; p < lay.npieces; ++p) {
    const int64_t c0 = row0 + lay.lo[p];
    T* dst = win + lay.base[p];
    for (int k = threadIdx.x * W; k < lay.len[p]; k += blockDim.x * W) {
      const int64_t c = c0 + k;
      if (c >= 0 && c + W <= gcols) {
        cp_async<W * (int)sizeof(T)>(dst + k, gs + c);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i)
          dst[k + i] = (c + i >= 0 && c + i < gcols) ? gs[c + i] : T(0);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // 2. the table, kChunk diagonals at a time; the first chunk's loads are in
  // flight while the window is copied
  const T* ds = dval + (int64_t)s * lay.n * Lrow;
  T acc[U][W];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < W; ++i) acc[u][i] = T(0);
  for (int c = 0; c < lay.n; c += kChunk) {
    T v[kChunk][U][W];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t i = row0 + (int64_t)(u * blockDim.x + threadIdx.x) * W;
        if (c + k < lay.n && i < Lrow) {
          ldcs(ds + (int64_t)(c + k) * Lrow + i, v[k][u]);
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) v[k][u][e] = T(0);
        }
      }
    if (c == 0) {   // every thread reaches it: the trip count is uniform
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (c + k >= lay.n) break;
      const T* xw = win + lay.shift[c + k];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = (u * blockDim.x + threadIdx.x) * W;
#pragma unroll
        for (int e = 0; e < W; ++e)
          acc[u][e] = term(acc[u][e], v[k][u][e], xw[r + e]);
      }
    }
  }
  T* ys = y + (int64_t)s * Lrow;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t i = row0 + (int64_t)(u * blockDim.x + threadIdx.x) * W;
    if (i < Lrow) stcs(ys + i, acc[u]);
  }
}

// two kernels with names of their own, so a profiler trace shows which ran
template <typename T>
__global__ void __launch_bounds__(DIA_THREADS)
    dia_vec(const T* __restrict__ dval, const T* __restrict__ g,
            T* __restrict__ y, int64_t Lrow, int64_t gcols, int64_t g_stride,
            const __grid_constant__ DiaLayout lay) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dia_tile<T, kRows<T>>(dval, g, y, Lrow, gcols, g_stride, lay,
                        reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(DIA_THREADS)
    dia_scalar(const T* __restrict__ dval, const T* __restrict__ g,
               T* __restrict__ y, int64_t Lrow, int64_t gcols,
               int64_t g_stride, const __grid_constant__ DiaLayout lay) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dia_tile<T, 1>(dval, g, y, Lrow, gcols, g_stride, lay,
                 reinterpret_cast<T*>(smem_raw));
}

// One launch. The kernel's shared-memory opt-in (needed above 48 KB) is
// set once per device and size, not on every launch: the runtime call is
// host time on a host-bound CG step.
template <typename T, bool VEC>
static int launch_kernel(const void* dval, const void* g, void* y, int64_t S,
                         int64_t Lrow, int64_t gcols, int64_t g_stride,
                         const DiaLayout& lay, int threads, size_t smem,
                         cudaStream_t st) {
  static int c_dev = -1;
  static size_t c_smem = 0;
  void (*kernel)(const T*, const T*, T*, int64_t, int64_t, int64_t,
                 DiaLayout);
  if constexpr (VEC)
    kernel = dia_vec<T>;
  else
    kernel = dia_scalar<T>;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev != c_dev || smem > c_smem)) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e == cudaSuccess) c_dev = dev, c_smem = smem;
    }
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t tile = (int64_t)threads * kRows<T>;
  dim3 grid((unsigned)((Lrow + tile - 1) / tile), (unsigned)S);
  kernel<<<grid, threads, smem, st>>>((const T*)dval, (const T*)g, (T*)y, Lrow,
                                      gcols, g_stride, lay);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* dval, const void* g, void* y, int64_t S,
                  int64_t Lrow, int64_t gcols, int64_t g_stride,
                  const void* layout, int threads, int vector, int64_t smem,
                  void* stream) {
  constexpr int V = kRows<T>;
  const DiaLayout& lay = *(const DiaLayout*)layout;
  if (lay.n < 1 || lay.n > DIA_MAX_OFFSETS || lay.npieces < 1 ||
      lay.npieces > DIA_MAX_OFFSETS || S < 1 || S > 65535 || Lrow < 1 ||
      threads < 32 || threads > DIA_THREADS || threads % 32 || smem < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!vector)
    return launch_kernel<T, false>(dval, g, y, S, Lrow, gcols, g_stride, lay,
                                   threads, (size_t)smem, st);
  if ((uintptr_t)dval % 16 || (uintptr_t)g % 16 || (uintptr_t)y % 16 ||
      Lrow % V || g_stride % V)
    return (int)cudaErrorMisalignedAddress;
  return launch_kernel<T, true>(dval, g, y, S, Lrow, gcols, g_stride, lay,
                                threads, (size_t)smem, st);
}

extern "C" {

// layout: a host DiaLayout (copied into the launch); threads: a block's
// threads (a tile is threads * 16 / sizeof(T) rows); vector: nonzero runs
// dia_vec (16-byte accesses: dval, g and y 16-byte aligned, Lrow and
// g_stride multiples of 16 / sizeof(T) rows), 0 runs dia_scalar; smem: the
// window's bytes. The _c64 / _c128 entry points take torch's interleaved
// complex64 / complex128 values, x and y. Returns cudaGetLastError() after
// the launch.
#define DIA_SPMV_ENTRY(NAME, T)                                              \
  int NAME(const void* dval, const void* g, void* y, int64_t S,             \
           int64_t Lrow, int64_t gcols, int64_t g_stride,                   \
           const void* layout, int threads, int vector, int64_t smem,       \
           void* stream) {                                                  \
    return launch<T>(dval, g, y, S, Lrow, gcols, g_stride, layout, threads, \
                     vector, smem, stream);                                 \
  }

DIA_SPMV_ENTRY(dia_spmv_f32, float)
DIA_SPMV_ENTRY(dia_spmv_f64, double)
DIA_SPMV_ENTRY(dia_spmv_c64, c64)
DIA_SPMV_ENTRY(dia_spmv_c128, c128)

// The opt-in maximum of dynamic shared memory a block may take on device
// (the kernels have no static shared memory); a negative cudaError_t on
// failure.
int64_t dia_spmv_smem_cap(int device) {
  int optin = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? (int64_t)optin : -(int64_t)e;
}

}  // extern "C"
