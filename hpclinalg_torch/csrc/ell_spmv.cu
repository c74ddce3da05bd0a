// K2: ELL gather SpMV with a COO tail, and a gather-only mode, for Hopper.
// All stacked shards run in one launch (blockIdx.y is the shard).
//
//   ELL:    y[s, r]  = sum_w vals[s, r, w] * g[s, cols[s, r, w]]
//   tail:   y[s, trows[s, j]] += tvals[s, j] * g[s, tgidx[s, j]]
//           (entries whose row is Lrow are dropped: the padding slots)
//   gather: xe[s, d] = src[s, d] >= 0 ? x[s, src[s, d]] : 0
//
// g[s, j] reads as 0 for j >= gcols: the zero padding of the JAX package's
// _pad_trunc (hpclinalg/ops/spmv.py) is a bounds mask here. Index tables
// are validated on the host when the plan is built; the kernels do not
// clip them.
//
// Replaces the TPU shuffle kernels hpclinalg/ops/pallas_shuffle.py::run_a,
// ::run_b1 and ::run_b2 (kern_a/kern_b1/kern_b2) with their SpMV epilogue
// (_spmv_pipeline.whole), and the XLA _ell_exec. The TPU needed three
// routing passes because it has no vector gather; this card reads x with
// its own gather (__ldg through the read-only cache).
//
// Bound: nnz * (sizeof(T) + 4) table bytes streamed once, plus the random
// reads of x, which L2 (50 MB) holds at the 1M-row size. The (Lrow, W)
// row-major tables keep the JAX layout; TPR = power-of-two threads share a
// row so that a warp reads 32 consecutive table entries (coalesced), and
// the row sum is a shuffle reduction inside each TPR-lane group. The tail
// is scatter-added with atomicAdd (native for f64 on sm_90), so its
// summation order is not deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__global__ void ell_rows(const T* __restrict__ vals, const int* __restrict__ cols,
                         const T* __restrict__ g, T* __restrict__ y,
                         int64_t Lrow, int W, int64_t gcols, int64_t g_stride,
                         int tpr) {
  const int s = blockIdx.y;
  const int rows_per_block = blockDim.x / tpr;
  const int64_t row = (int64_t)blockIdx.x * rows_per_block + threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  T acc = T(0);
  if (row < Lrow) {
    const int64_t base = ((int64_t)s * Lrow + row) * W;
    const T* gs = g + (int64_t)s * g_stride;
    for (int w = lane; w < W; w += tpr) {
      const int j = cols[base + w];
      const T xv = (j < gcols) ? __ldg(gs + j) : T(0);
      acc += vals[base + w] * xv;
    }
  }
  for (int o = tpr / 2; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o, tpr);
  if (lane == 0 && row < Lrow) y[(int64_t)s * Lrow + row] = acc;
}

template <typename T>
__global__ void ell_tail(const T* __restrict__ tvals, const int* __restrict__ trows,
                         const int* __restrict__ tgidx, const T* __restrict__ g,
                         T* __restrict__ y, int64_t Lrow, int64_t Tpad,
                         int64_t gcols, int64_t g_stride) {
  const int s = blockIdx.y;
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Tpad) return;
  const int64_t k = (int64_t)s * Tpad + j;
  const int r = trows[k];
  if (r >= Lrow) return;  // padding slot: dropped
  const int c = tgidx[k];
  const T xv = (c < gcols) ? __ldg(g + (int64_t)s * g_stride + c) : T(0);
  atomicAdd(y + (int64_t)s * Lrow + r, tvals[k] * xv);
}

template <typename T>
__global__ void gather_rows(const T* __restrict__ x, const int* __restrict__ src,
                            T* __restrict__ xe, int64_t D, int64_t x_stride) {
  const int s = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int j = src[(int64_t)s * D + d];
  xe[(int64_t)s * D + d] = (j >= 0) ? __ldg(x + (int64_t)s * x_stride + j) : T(0);
}

template <typename T>
static int launch_ell(const void* vals, const void* cols, const void* tvals,
                      const void* trows, const void* tgidx, const void* g,
                      void* y, int64_t S, int64_t Lrow, int W, int64_t Tpad,
                      int64_t gcols, int64_t g_stride, int tpr, int threads,
                      void* stream) {
  if (S < 1 || S > 65535 || Lrow < 1 || W < 1 || tpr < 1 || tpr > 32 ||
      (tpr & (tpr - 1)) || threads % 32 || threads % tpr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rpb = threads / tpr;
  dim3 grid((unsigned)((Lrow + rpb - 1) / rpb), (unsigned)S);
  ell_rows<T><<<grid, threads, 0, st>>>((const T*)vals, (const int*)cols,
                                        (const T*)g, (T*)y, Lrow, W, gcols,
                                        g_stride, tpr);
  if (Tpad > 0) {
    dim3 tgrid((unsigned)((Tpad + threads - 1) / threads), (unsigned)S);
    ell_tail<T><<<tgrid, threads, 0, st>>>(
        (const T*)tvals, (const int*)trows, (const int*)tgidx, (const T*)g,
        (T*)y, Lrow, Tpad, gcols, g_stride);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_gather(const void* x, const void* src, void* xe, int64_t S,
                         int64_t D, int64_t x_stride, int threads,
                         void* stream) {
  if (S < 1 || S > 65535 || D < 1 || threads % 32)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((D + threads - 1) / threads), (unsigned)S);
  gather_rows<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const int*)src, (T*)xe, D, x_stride);
  return (int)cudaGetLastError();
}

extern "C" {

// Tpad == 0 means no tail (tvals/trows/tgidx are then not read).
// Returns cudaGetLastError() after the launches.
int ell_spmv_f32(const void* vals, const void* cols, const void* tvals,
                 const void* trows, const void* tgidx, const void* g, void* y,
                 int64_t S, int64_t Lrow, int W, int64_t Tpad, int64_t gcols,
                 int64_t g_stride, int tpr, int threads, void* stream) {
  return launch_ell<float>(vals, cols, tvals, trows, tgidx, g, y, S, Lrow, W,
                           Tpad, gcols, g_stride, tpr, threads, stream);
}

int ell_spmv_f64(const void* vals, const void* cols, const void* tvals,
                 const void* trows, const void* tgidx, const void* g, void* y,
                 int64_t S, int64_t Lrow, int W, int64_t Tpad, int64_t gcols,
                 int64_t g_stride, int tpr, int threads, void* stream) {
  return launch_ell<double>(vals, cols, tvals, trows, tgidx, g, y, S, Lrow, W,
                            Tpad, gcols, g_stride, tpr, threads, stream);
}

int gather_f32(const void* x, const void* src, void* xe, int64_t S, int64_t D,
               int64_t x_stride, int threads, void* stream) {
  return launch_gather<float>(x, src, xe, S, D, x_stride, threads, stream);
}

int gather_f64(const void* x, const void* src, void* xe, int64_t S, int64_t D,
               int64_t x_stride, int threads, void* stream) {
  return launch_gather<double>(x, src, xe, S, D, x_stride, threads, stream);
}

}  // extern "C"
