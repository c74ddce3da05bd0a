// K2: ELL gather SpMV with a COO tail, and a gather-only mode, for Hopper.
// All stacked shards run in one launch (blockIdx.y is the shard).
//
//   ELL:    y[s, r]  = sum_{w < len[s, r]} vals[s, r, w] * g[s, cols[s, r, w]]
//   tail:   y[s, trows[s, j]] += tvals[s, j] * g[s, tgidx[s, j]]
//           (entries whose row is Lrow are dropped: the padding slots)
//   gather: xe[s, d] = src[s, d] >= 0 ? x[s, src[s, d]] : 0
//
// len[s, r] = min(row length, W) is the plan's row-length table: the
// padding past it (value 0, column 0) is never read. g[s, j] reads
// as 0 for j >= gcols: the zero padding of the JAX package's _pad_trunc
// (hpclinalg/ops/spmv.py) is a bounds mask here. Index tables are validated
// on the host when the plan is built; the kernels do not clip them.
//
// Replaces the TPU shuffle kernels hpclinalg/ops/pallas_shuffle.py::run_a,
// ::run_b1 and ::run_b2 (kern_a/kern_b1/kern_b2) with their SpMV epilogue
// (_spmv_pipeline.whole), and the XLA _ell_exec. The TPU needed three
// routing passes because it has no vector gather; this card reads x with
// its own gather (__ldg through the read-only cache).
//
// Bound: bytes. The stored entries (value + column index), the row-length
// table, the tail's entries (value, row, column), x once and y once, over
// 3.35 TB/s; x is read at random but L2 (50 MB) holds it at the 10^6-row
// size. What bounds it on a random pattern in practice is L2: each x read
// is a 32-byte sector request of its own (on the H100 the gather mode at
// 8*10^6 random slots takes about twice its time with sequential slots of
// the same bytes; see PERF.md). Design (csrc/ell_common.cuh): a thread
// group a row, its table loads pipelined one unit ahead of its x reads,
// 16-byte loads of values where the row width allows, groups sized from
// the row lengths so short rows share a warp, and a stop at each row's
// length; the tail sums runs of one row inside a warp before its one
// atomicAdd (native for f64 on sm_90; a complex value adds its two
// components with one atomic each), so its summation order is not
// deterministic. Values are f32, f64, c64 or c128 (csrc/values.cuh), each
// type one instantiation of the same kernels: a complex product is one
// launch on the interleaved values, not four real ones. The gather mode stays one slot a thread: on the H100
// every design with more slots a thread (4 or 8, with 16-byte loads of the
// sources and 16-byte stores) measured slower at 8*10^6 random slots, where
// the random x reads bound it (PERF.md).

#include "ell_common.cuh"

constexpr int kGatherThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kRowThreads, kRowBlocksPerSM)
ell_rows(const T* __restrict__ vals, const int* __restrict__ cols,
         const int* __restrict__ rowlen, const T* __restrict__ g,
         T* __restrict__ y, int64_t Lrow, int W, int64_t gcols,
         int64_t g_stride, int tpr_log2) {
  const int s = blockIdx.y;
  const int groups = blockDim.x >> tpr_log2;
  const int group = threadIdx.x >> tpr_log2;
  const int lane = threadIdx.x & ((1 << tpr_log2) - 1);
  const int64_t off = (int64_t)s * Lrow;
  const GlobalX<T> xr{g + (int64_t)s * g_stride, gcols};
  // the loop bound is the same for the whole block (the shuffles need
  // whole warps)
  for (int64_t base = (int64_t)blockIdx.x * groups; base < Lrow;
       base += (int64_t)gridDim.x * groups)
    ell_row_pass<T, VEC>(vals + off * W, cols + off * W, rowlen + off,
                         y + off, Lrow, W, base, group, lane, tpr_log2, xr,
                         NoWait{});
}

// one slot a thread: a coalesced load of its source, one x load, a
// coalesced store
template <typename T>
__global__ void gather_rows(const T* __restrict__ x, const int* __restrict__ src,
                            T* __restrict__ xe, int64_t D, int64_t x_stride) {
  const int s = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int j = src[(int64_t)s * D + d];
  xe[(int64_t)s * D + d] = (j >= 0) ? __ldg(x + (int64_t)s * x_stride + j) : T(0);
}

template <typename T, int VEC>
static void launch_rows(const void* vals, const void* cols, const void* rowlen,
                        const void* g, void* y, int64_t S, int64_t Lrow, int W,
                        int64_t gcols, int64_t g_stride, int tpr_log2,
                        cudaStream_t st) {
  const int64_t rows_per_block = kRowThreads >> tpr_log2;
  int64_t blocks = (Lrow + rows_per_block - 1) / rows_per_block;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  dim3 grid((unsigned)blocks, (unsigned)S);
  ell_rows<T, VEC><<<grid, kRowThreads, 0, st>>>(
      (const T*)vals, (const int*)cols, (const int*)rowlen, (const T*)g,
      (T*)y, Lrow, W, gcols, g_stride, tpr_log2);
}

template <typename T>
static int launch_ell(const void* vals, const void* cols, const void* rowlen,
                      const void* tvals, const void* trows, const void* tgidx,
                      const void* g, void* y, int64_t S, int64_t Lrow, int W,
                      int64_t Tpad, int64_t gcols, int64_t g_stride, int tpr,
                      int vec, void* stream) {
  constexpr int V = kVec<T>;
  if (rowlen == nullptr || S < 1 || S > 65535 || Lrow < 1 || W < 1 ||
      tpr < 1 || tpr > 32 || (tpr & (tpr - 1)) || (vec != 1 && vec != V) ||
      W % vec || Tpad % kTailPerThread)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int l2 = log2_pow2(tpr);
  if (vec == V)
    launch_rows<T, V>(vals, cols, rowlen, g, y, S, Lrow, W, gcols, g_stride, l2, st);
  else
    launch_rows<T, 1>(vals, cols, rowlen, g, y, S, Lrow, W, gcols, g_stride, l2, st);
  if (Tpad > 0)
    launch_tail<T>(tvals, trows, tgidx, g, y, S, Lrow, Tpad, gcols, g_stride, st);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_gather(const void* x, const void* src, void* xe, int64_t S,
                         int64_t D, int64_t x_stride, void* stream) {
  if (S < 1 || S > 65535 || D < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((D + kGatherThreads - 1) / kGatherThreads),
            (unsigned)S);
  gather_rows<T><<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const int*)src, (T*)xe, D, x_stride);
  return (int)cudaGetLastError();
}

extern "C" {

// rowlen: (S, Lrow) stored row lengths. vec is 1 or 16 / sizeof(T) entries
// a load (then W % vec == 0 and the tables 16-byte aligned); Tpad == 0
// means no tail (tvals/trows/tgidx are then not read), else Tpad % 8 == 0
// and the tail tables 16-byte aligned. The _c64 / _c128 entry points take
// torch's interleaved complex64 / complex128 values, x and y.
// Returns cudaGetLastError() after the launches.
#define ELL_SPMV_ENTRY(NAME, T)                                              \
  int NAME(const void* vals, const void* cols, const void* rowlen,          \
           const void* tvals, const void* trows, const void* tgidx,         \
           const void* g, void* y, int64_t S, int64_t Lrow, int W,          \
           int64_t Tpad, int64_t gcols, int64_t g_stride, int tpr, int vec, \
           void* stream) {                                                  \
    return launch_ell<T>(vals, cols, rowlen, tvals, trows, tgidx, g, y, S,  \
                         Lrow, W, Tpad, gcols, g_stride, tpr, vec, stream); \
  }

ELL_SPMV_ENTRY(ell_spmv_f32, float)
ELL_SPMV_ENTRY(ell_spmv_f64, double)
ELL_SPMV_ENTRY(ell_spmv_c64, c64)
ELL_SPMV_ENTRY(ell_spmv_c128, c128)

// the gather mode moves reals only: a complex payload crosses it as real
// pairs (parallel/exchange.py)
int gather_f32(const void* x, const void* src, void* xe, int64_t S, int64_t D,
               int64_t x_stride, void* stream) {
  return launch_gather<float>(x, src, xe, S, D, x_stride, stream);
}

int gather_f64(const void* x, const void* src, void* xe, int64_t S, int64_t D,
               int64_t x_stride, void* stream) {
  return launch_gather<double>(x, src, xe, S, D, x_stride, stream);
}

}  // extern "C"
