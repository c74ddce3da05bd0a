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
// with two DMAs in flight per chunk), here the launch's depth.
//
// Bound: device-memory bytes. dia_flat_spmv moves (O + 2) * ntiles * TR
// elements (the table once, x and y once each); table_stream R + 1. Both
// read the table coalesced (consecutive threads, consecutive rows of one
// diagonal). dia_flat_spmv reads x through the read-only data cache
// (__ldg): the O shifted reads of one row hit the same few lines, so x
// costs about one pass from device memory.
//
// table_stream is a stream, so what bounds it is the bytes in flight: one
// 4-byte load a thread moves about 1 TB/s on the H100. Its main kernel,
// table_stream_vec, reads and writes 16 bytes an access (float4, double2)
// with the streaming hint (ld/st.global.cs: the bytes are touched once),
// and gives each thread U = 2 * depth units of 16 bytes along a tile, all
// U * R loads issued before any sum: depth multiplies the loads in flight
// a thread (v5_d2, v5_d3 against v3 measure more against fewer). A block
// takes 256 * U units of one tile. It needs tbl and y 16-byte aligned and
// TR, tile_stride and row_stride multiples of the vector width (the
// wrapper picks it by those facts alone). Any other table runs
// table_stream_scalar: a tile per grid row, one element a thread and row,
// depth rows of a tile, a depth-th of the tile apart, loaded before any
// sum.
// Each term is rounded as product, then sum (no fused multiply-add), in t
// order: the arithmetic of the plain versions in ops/cuda_dia_probe.py, so
// the kernels agree with them bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_MAX_OFFSETS 64
#define STREAM_MAX_R 8
#define STREAM_THREADS 256  // table_stream_vec's block

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

// dia_flat_spmv and table_stream_scalar take a tile per grid row
// (blockIdx.y) and a row of it per thread: no division by TR on the card.
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
__global__ void table_stream_scalar(const T* __restrict__ tbl,
                                    const T* __restrict__ c,
                                    T* __restrict__ y, int TR, int R,
                                    int64_t tile_stride, int64_t row_stride,
                                    T scale) {
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

// 16 bytes of T, read and written with the streaming hint (evict first:
// each byte is touched once)
__device__ __forceinline__ void ld16(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void ld16(const double* p, double (&v)[2]) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void st16(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void st16(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// A block per item (chunk blockIdx.x of tile blockIdx.y), a chunk being
// 256 * U units of W elements: thread x covers units
// chunk * 256 * U + u * 256 + x, so a warp's access is 512 contiguous bytes.
template <typename T, int R, int U>
__global__ void __launch_bounds__(STREAM_THREADS)
    table_stream_vec(const T* __restrict__ tbl, const T* __restrict__ c,
                     T* __restrict__ y, int TR, int64_t tile_stride,
                     int64_t row_stride, T scale) {
  constexpr int W = 16 / sizeof(T);
  const int r0 = (int)blockIdx.x * (STREAM_THREADS * U) + (int)threadIdx.x;
  const T* base = tbl + (int64_t)blockIdx.y * tile_stride;
  T v[U][R][W];
  // every load of the thread's U units first ...
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = (r0 + u * STREAM_THREADS) * W;
    if (e < TR) {
#pragma unroll
      for (int t = 0; t < R; ++t) ld16(base + t * row_stride + e, v[u][t]);
    }
  }
  // ... then the sums
  const T c0 = *c;
  T* yt = y + (int64_t)blockIdx.y * TR;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = (r0 + u * STREAM_THREADS) * W;
    if (e < TR) {
      T o[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        T acc = c0;
#pragma unroll
        for (int t = 0; t < R; ++t) acc = mul_add_rn(acc, scale, v[u][t][i]);
        o[i] = acc;
      }
      st16(yt + e, o);
    }
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
static int launch_scalar(const T* tp, const T* cp, T* yp, int64_t ntiles,
                         int TR, int R, int64_t tile_stride,
                         int64_t row_stride, T scale, int depth, int threads,
                         cudaStream_t st) {
  const int Gt = (TR + depth - 1) / depth;
  dim3 grid((unsigned)((Gt + threads - 1) / threads), (unsigned)ntiles);
  switch (depth) {
    case 1:
      table_stream_scalar<T, 1><<<grid, threads, 0, st>>>(
          tp, cp, yp, TR, R, tile_stride, row_stride, scale);
      break;
    case 2:
      table_stream_scalar<T, 2><<<grid, threads, 0, st>>>(
          tp, cp, yp, TR, R, tile_stride, row_stride, scale);
      break;
    case 3:
      table_stream_scalar<T, 3><<<grid, threads, 0, st>>>(
          tp, cp, yp, TR, R, tile_stride, row_stride, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int R, int DEPTH>
static int launch_vec(const T* tp, const T* cp, T* yp, int64_t ntiles,
                      int TR, int64_t tile_stride, int64_t row_stride,
                      T scale, cudaStream_t st) {
  constexpr int U = 2 * DEPTH;
  constexpr int W = 16 / sizeof(T);
  const int per = STREAM_THREADS * U * W;       // elements a block
  dim3 grid((unsigned)((TR + per - 1) / per), (unsigned)ntiles);
  table_stream_vec<T, R, U><<<grid, STREAM_THREADS, 0, st>>>(
      tp, cp, yp, TR, tile_stride, row_stride, scale);
  return (int)cudaGetLastError();
}

template <typename T, int R>
static int launch_vec_depth(const T* tp, const T* cp, T* yp, int64_t ntiles,
                            int TR, int64_t tile_stride, int64_t row_stride,
                            T scale, int depth, cudaStream_t st) {
  switch (depth) {
    case 1:
      return launch_vec<T, R, 1>(tp, cp, yp, ntiles, TR, tile_stride,
                                 row_stride, scale, st);
    case 2:
      return launch_vec<T, R, 2>(tp, cp, yp, ntiles, TR, tile_stride,
                                 row_stride, scale, st);
    case 3:
      return launch_vec<T, R, 3>(tp, cp, yp, ntiles, TR, tile_stride,
                                 row_stride, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_stream(const void* tbl, const void* c, void* y,
                         int64_t ntiles, int TR, int R, int64_t tile_stride,
                         int64_t row_stride, double scale, int depth,
                         int threads, int vec, void* stream) {
  constexpr int W = 16 / sizeof(T);
  if (R < 1 || R > STREAM_MAX_R || ntiles < 1 || ntiles > 65535 || TR < 1 ||
      threads < 1 || depth < 1 || depth > 3 || (vec != 1 && vec != W))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const T* tp = (const T*)tbl;
  const T* cp = (const T*)c;
  T* yp = (T*)y;
  const T sc = (T)scale;
  if (vec == 1)
    return launch_scalar<T>(tp, cp, yp, ntiles, TR, R, tile_stride,
                            row_stride, sc, depth, threads, st);
  if ((uintptr_t)tbl % 16 || (uintptr_t)y % 16 || TR % W || tile_stride % W ||
      row_stride % W || TR > (1 << 30))
    return (int)cudaErrorMisalignedAddress;
  switch (R) {
#define STREAM_R(r)                                                       \
  case r:                                                                 \
    return launch_vec_depth<T, r>(tp, cp, yp, ntiles, TR, tile_stride,    \
                                  row_stride, sc, depth, st);
    STREAM_R(1) STREAM_R(2) STREAM_R(3) STREAM_R(4)
    STREAM_R(5) STREAM_R(6) STREAM_R(7) STREAM_R(8)
#undef STREAM_R
  }
  return (int)cudaErrorInvalidValue;
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

// depth: 1, 2 or 3 (the loads in flight a thread: see the header); vec: 1
// for table_stream_scalar, the vector width (4 in f32, 2 in f64) for
// table_stream_vec; threads: table_stream_scalar's block.
int table_stream_f32(const void* tbl, const void* c, void* y, int64_t ntiles,
                     int TR, int R, int64_t tile_stride, int64_t row_stride,
                     double scale, int depth, int threads, int vec,
                     void* stream) {
  return launch_stream<float>(tbl, c, y, ntiles, TR, R, tile_stride,
                              row_stride, scale, depth, threads, vec, stream);
}

int table_stream_f64(const void* tbl, const void* c, void* y, int64_t ntiles,
                     int TR, int R, int64_t tile_stride, int64_t row_stride,
                     double scale, int depth, int threads, int vec,
                     void* stream) {
  return launch_stream<double>(tbl, c, y, ntiles, TR, R, tile_stride,
                               row_stride, scale, depth, threads, vec,
                               stream);
}

}  // extern "C"
