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
// Bound: device-memory bytes, (O + 2) * Lrow * S * sizeof(T) per product
// (the table is streamed once; x and y once each). The design keeps the
// table stream coalesced (consecutive threads read consecutive rows of one
// diagonal) and reads x from device memory once per tile:
//   * dia_smem: a block stages g[tile + minoff, tile + TR + maxoff) in
//     shared memory and every diagonal reads its shifted window from there;
//   * dia_ldg: when the offset span does not fit in shared memory, x is
//     read through the read-only data cache (__ldg) instead.
// The wrapper (hpclinalg_torch/ops/cuda_dia.py) picks the variant by span.
// The offsets travel as a by-value kernel argument, so one compiled kernel
// serves every pattern of up to DIA_MAX_OFFSETS diagonals.
// Each term is rounded as product, then sum (no fused multiply-add), in
// offset order: the arithmetic of the plain twin and of _dia_exec, so the
// kernel agrees with its twin bit for bit. The kernel is bound by memory,
// so the unfused arithmetic costs nothing measurable.

#include <cuda_runtime.h>
#include <stdint.h>

#define DIA_MAX_OFFSETS 64

struct DiaOffsets {
  int n;
  int off[DIA_MAX_OFFSETS];
};

// acc + a*b with two roundings; the intrinsics are never contracted
__device__ __forceinline__ float mul_add_rn(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ double mul_add_rn(double acc, double a, double b) {
  return __dadd_rn(acc, __dmul_rn(a, b));
}

template <typename T>
__global__ void dia_smem(const T* __restrict__ dval, const T* __restrict__ g,
                         T* __restrict__ y, int64_t Lrow, int64_t gcols,
                         int64_t g_stride, DiaOffsets offs, int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* win = reinterpret_cast<T*>(smem_raw);
  const int s = blockIdx.y;
  const int minoff = offs.off[0];
  const int span = offs.off[offs.n - 1] - minoff;
  const int64_t row0 = (int64_t)blockIdx.x * tile;
  const T* gs = g + (int64_t)s * g_stride;
  const int64_t wlo = row0 + minoff;
  const int wlen = tile + span;
  for (int k = threadIdx.x; k < wlen; k += blockDim.x) {
    const int64_t j = wlo + k;
    win[k] = (j >= 0 && j < gcols) ? gs[j] : T(0);
  }
  __syncthreads();
  const T* ds = dval + (int64_t)s * offs.n * Lrow;
  T* ys = y + (int64_t)s * Lrow;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int64_t i = row0 + r;
    if (i >= Lrow) break;
    T acc = T(0);
    for (int t = 0; t < offs.n; ++t)
      acc = mul_add_rn(acc, ds[(int64_t)t * Lrow + i],
                       win[r + offs.off[t] - minoff]);
    ys[i] = acc;
  }
}

template <typename T>
__global__ void dia_ldg(const T* __restrict__ dval, const T* __restrict__ g,
                        T* __restrict__ y, int64_t Lrow, int64_t gcols,
                        int64_t g_stride, DiaOffsets offs) {
  const int s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Lrow) return;
  const T* gs = g + (int64_t)s * g_stride;
  const T* ds = dval + (int64_t)s * offs.n * Lrow;
  T acc = T(0);
  for (int t = 0; t < offs.n; ++t) {
    const int64_t j = i + offs.off[t];
    const T xv = (j >= 0 && j < gcols) ? __ldg(gs + j) : T(0);
    acc = mul_add_rn(acc, ds[(int64_t)t * Lrow + i], xv);
  }
  y[(int64_t)s * Lrow + i] = acc;
}

template <typename T>
static int launch(const void* dval, const void* g, void* y, int64_t S,
                  int64_t Lrow, int64_t gcols, int64_t g_stride, int O,
                  const int* offsets, int variant, int tile, int threads,
                  void* stream) {
  if (O < 1 || O > DIA_MAX_OFFSETS || S < 1 || S > 65535 || Lrow < 1)
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.n = O;
  for (int t = 0; t < O; ++t) offs.off[t] = offsets[t];
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    const int span = offsets[O - 1] - offsets[0];
    const size_t smem = (size_t)(tile + span) * sizeof(T);
    cudaError_t e = cudaFuncSetAttribute(
        dia_smem<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((Lrow + tile - 1) / tile), (unsigned)S);
    dia_smem<T><<<grid, threads, smem, st>>>(
        (const T*)dval, (const T*)g, (T*)y, Lrow, gcols, g_stride, offs, tile);
  } else {
    dim3 grid((unsigned)((Lrow + threads - 1) / threads), (unsigned)S);
    dia_ldg<T><<<grid, threads, 0, st>>>(
        (const T*)dval, (const T*)g, (T*)y, Lrow, gcols, g_stride, offs);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// variant 0: shared-memory window (needs (tile + span) * sizeof(T) bytes of
// dynamic shared memory); variant 1: __ldg reads. offsets: host array of O
// ascending ints. Returns cudaGetLastError() after the launch.
int dia_spmv_f32(const void* dval, const void* g, void* y, int64_t S,
                 int64_t Lrow, int64_t gcols, int64_t g_stride, int O,
                 const int* offsets, int variant, int tile, int threads,
                 void* stream) {
  return launch<float>(dval, g, y, S, Lrow, gcols, g_stride, O, offsets,
                       variant, tile, threads, stream);
}

int dia_spmv_f64(const void* dval, const void* g, void* y, int64_t S,
                 int64_t Lrow, int64_t gcols, int64_t g_stride, int O,
                 const int* offsets, int variant, int tile, int threads,
                 void* stream) {
  return launch<double>(dval, g, y, S, Lrow, gcols, g_stride, O, offsets,
                        variant, tile, threads, stream);
}

}  // extern "C"
