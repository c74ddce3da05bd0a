// K4: the DIA probe kernels for Hopper — the stencil SpMV on a tile-flat
// table and the table-stream probe.
//
// dia_flat_spmv, on a table laid out tile by tile, (ntiles, O, TR):
//
//   y[i] = sum_t tbl[i / TR, t, i % TR] * xp[i + off_t - off_0]   (aligned = 0)
//   y[i] = sum_t tbl[i / TR, t, i % TR] * xp[i]                   (aligned = 1)
//
// for 0 <= i < ntiles * TR, with xp the x vector pre-padded by -off_0 zeros
// on the left and long enough on the right (the wrapper checks). Replaces
// the TPU kernels of tools/probe_dia_kernels.py: kern4 (v4, the DIA SpMV on
// the tile-flat table and a padded x window, double-buffered by manual DMA)
// and kern1 (v1, every read at the window base: wrong by design, it prices
// the shifted reads).
//
// table_stream:
//
//   y[i] = c + sum_{t < R} scale * tbl[(i / TR) * tile_stride + t * row_stride
//                                      + i % TR]
//
// with c one element in device memory. Replaces the table-stream probes:
// skern of tools/bench_dia_variants.py (R = 1, scale = 0.125, on the
// (O, ntiles * TR) table), kern3 of tools/probe_dia_kernels.py (v3: R = O,
// scale = 1, on the tile-flat table) and kern5 of its ring_probe (v5: v3
// with two DMAs in flight per chunk), here the template's DEPTH.
//
// Bound: device-memory bytes. dia_flat_spmv moves (O + 2) * ntiles * TR
// elements (the table once, x and y once each); table_stream R + 1. Both
// read the table coalesced (consecutive threads, consecutive rows of one
// diagonal). dia_flat_spmv reads x through the read-only data cache
// (__ldg): the O shifted reads of one row hit the same few lines, so x
// costs about one pass from device memory. table_stream's DEPTH is how many
// rows of a tile, a DEPTH-th of the tile apart, each thread loads before it
// sums any: the card's counterpart of the TPU probe's copies in flight. A
// cp.async or TMA ring is later work.
// Each term is rounded as product, then sum (no fused multiply-add), in t
// order: the arithmetic of the plain versions in ops/cuda_dia_probe.py, so
// the kernels agree with them bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_MAX_OFFSETS 64
#define STREAM_MAX_R 8

struct ProbeOffsets {
  int n;
  int off[PROBE_MAX_OFFSETS];
};

__device__ __forceinline__ float mul_add_rn(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ double mul_add_rn(double acc, double a, double b) {
  return __dadd_rn(acc, __dmul_rn(a, b));
}

// Both kernels take a tile per grid row (blockIdx.y) and a row of it per
// thread: no division by TR on the card.
template <typename T>
__global__ void dia_flat_spmv(const T* __restrict__ tbl,
                              const T* __restrict__ xp, T* __restrict__ y,
                              int TR, ProbeOffsets offs, int aligned) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= TR) return;
  const int64_t i = (int64_t)blockIdx.y * TR + r;
  const T* tt = tbl + (int64_t)blockIdx.y * offs.n * TR + r;
  const int off0 = offs.off[0];
  T acc = T(0);
  for (int t = 0; t < offs.n; ++t) {
    const int64_t j = aligned ? i : i + (offs.off[t] - off0);
    acc = mul_add_rn(acc, tt[(int64_t)t * TR], __ldg(xp + j));
  }
  y[i] = acc;
}

template <typename T, int DEPTH>
__global__ void table_stream(const T* __restrict__ tbl,
                             const T* __restrict__ c, T* __restrict__ y,
                             int TR, int R, int64_t tile_stride,
                             int64_t row_stride, T scale) {
  const int Gt = (TR + DEPTH - 1) / DEPTH;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= Gt) return;
  const T* base = tbl + (int64_t)blockIdx.y * tile_stride;
  T* yt = y + (int64_t)blockIdx.y * TR;
  T v[DEPTH][STREAM_MAX_R];
  // every load of the thread's DEPTH rows first ...
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int r = g + d * Gt;
    const bool live = r < TR;
    const T* p = base + (live ? r : 0);
#pragma unroll
    for (int t = 0; t < STREAM_MAX_R; ++t)
      v[d][t] = (live && t < R) ? p[(int64_t)t * row_stride] : T(0);
  }
  // ... then the sums
  const T c0 = *c;
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const int r = g + d * Gt;
    if (r >= TR) break;
    T acc = c0;
#pragma unroll
    for (int t = 0; t < STREAM_MAX_R; ++t)
      if (t < R) acc = mul_add_rn(acc, scale, v[d][t]);
    yt[r] = acc;
  }
}

template <typename T>
static int launch_flat(const void* tbl, const void* xp, void* y,
                       int64_t ntiles, int TR, int O, const int* offsets,
                       int aligned, int threads, void* stream) {
  if (O < 1 || O > PROBE_MAX_OFFSETS || ntiles < 1 || ntiles > 65535 ||
      TR < 1 || threads < 1)
    return (int)cudaErrorInvalidValue;
  ProbeOffsets offs;
  offs.n = O;
  for (int t = 0; t < O; ++t) offs.off[t] = offsets[t];
  dim3 grid((unsigned)((TR + threads - 1) / threads), (unsigned)ntiles);
  dia_flat_spmv<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)tbl, (const T*)xp, (T*)y, TR, offs, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_stream(const void* tbl, const void* c, void* y,
                         int64_t ntiles, int TR, int R, int64_t tile_stride,
                         int64_t row_stride, double scale, int depth,
                         int threads, void* stream) {
  if (R < 1 || R > STREAM_MAX_R || ntiles < 1 || ntiles > 65535 || TR < 1 ||
      threads < 1 || depth < 1)
    return (int)cudaErrorInvalidValue;
  const int Gt = (TR + depth - 1) / depth;
  dim3 grid((unsigned)((Gt + threads - 1) / threads), (unsigned)ntiles);
  cudaStream_t st = (cudaStream_t)stream;
  const T* tp = (const T*)tbl;
  const T* cp = (const T*)c;
  T* yp = (T*)y;
  switch (depth) {
    case 1:
      table_stream<T, 1><<<grid, threads, 0, st>>>(
          tp, cp, yp, TR, R, tile_stride, row_stride, (T)scale);
      break;
    case 2:
      table_stream<T, 2><<<grid, threads, 0, st>>>(
          tp, cp, yp, TR, R, tile_stride, row_stride, (T)scale);
      break;
    case 3:
      table_stream<T, 3><<<grid, threads, 0, st>>>(
          tp, cp, yp, TR, R, tile_stride, row_stride, (T)scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// offsets: host array of O ascending ints (by value into the kernel).
// Returns cudaGetLastError() after the launch.
int dia_flat_spmv_f32(const void* tbl, const void* xp, void* y,
                      int64_t ntiles, int TR, int O, const int* offsets,
                      int aligned, int threads, void* stream) {
  return launch_flat<float>(tbl, xp, y, ntiles, TR, O, offsets, aligned,
                            threads, stream);
}

int dia_flat_spmv_f64(const void* tbl, const void* xp, void* y,
                      int64_t ntiles, int TR, int O, const int* offsets,
                      int aligned, int threads, void* stream) {
  return launch_flat<double>(tbl, xp, y, ntiles, TR, O, offsets, aligned,
                             threads, stream);
}

// depth: 1, 2 or 3 rows loaded per thread before any sum.
int table_stream_f32(const void* tbl, const void* c, void* y, int64_t ntiles,
                     int TR, int R, int64_t tile_stride, int64_t row_stride,
                     double scale, int depth, int threads, void* stream) {
  return launch_stream<float>(tbl, c, y, ntiles, TR, R, tile_stride,
                              row_stride, scale, depth, threads, stream);
}

int table_stream_f64(const void* tbl, const void* c, void* y, int64_t ntiles,
                     int TR, int R, int64_t tile_stride, int64_t row_stride,
                     double scale, int depth, int threads, void* stream) {
  return launch_stream<double>(tbl, c, y, ntiles, TR, R, tile_stride,
                               row_stride, scale, depth, threads, stream);
}

}  // extern "C"
