// K3: ELL SpMV with the whole gathered x resident in shared memory, for
// Hopper. All stacked shards run in one launch (blockIdx.y is the shard).
//
//   y[s, r]  = sum_w vals[s, r, w] * g[s, cols[s, r, w]]
//   tail:      y[s, trows[s, j]] += tvals[s, j] * g[s, tgidx[s, j]]
//              (entries whose row is Lrow are dropped: the padding slots)
//
// K2's function (csrc/ell_spmv.cu) on the same plan tables. g[s, j] reads
// as 0 for j >= gcols: the zero padding of the JAX package's _pad_trunc is
// a mask applied while x is staged, so no padded copy of x is made. Index
// tables are validated on the host when the plan is built; the kernel does
// not clip them.
//
// Replaces the TPU kernel hpclinalg/ops/pallas_csr.py::_pallas_ell_fn
// (kern): 2048-row tiles of an ELL table against a gathered x held whole
// in VMEM. Mosaic cannot lower that in-VMEM gather, so the TPU kernel was
// never deployed; the card gathers from shared memory natively.
//
// Design. Each block stages its shard's whole gathered x, g[s, :G], in
// dynamic shared memory once (G * sizeof(T) <= the opt-in maximum per
// block, 227 KiB on an H100), then reads x there. The grid is persistent:
// as many blocks as fit on the card at once, shared among the shards, each
// striding over row tiles, so the staging traffic is about (blocks on the
// card) * G * sizeof(T) bytes per product, read from L2, instead of one
// staging per row tile. Rows are laid out as in K2: a power-of-two group
// of TPR threads shares a row so a warp reads consecutive table entries,
// and a shuffle reduction sums the row, in K2's order (without a tail, K3
// and K2 agree bit for bit); each group takes kRowsPerPass rows a pass.
//
// Bound: nnz * (sizeof(T) + 4) table bytes streamed once from HBM (37 MB
// for the ridge-regression normal matrix in f64), plus y; the x reads hit
// shared memory (random 8-byte reads cost bank conflicts, not HBM bytes).
// Before its first row each block reads G * sizeof(T) bytes of x from L2
// (17 MB over 132 blocks for that matrix at one shard), and a G that large
// leaves one block of 32 warps on an SM; K2 reads x through L1 and L2 at
// full occupancy and is faster at one shard on the shapes measured so far
// (PERF.md has both times).
// The tail is scatter-added with atomicAdd (native for f64 on sm_90), so
// its summation order is not deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

// R rows per thread group and pass: the loads of R rows are issued
// together, so each thread keeps R table reads in flight (one block per SM
// at a large G leaves only 32 warps on the SM to hide HBM latency with).
// R = 2 measured best of 1, 2 and 4 on the ridge path's shapes.
constexpr int kRowsPerPass = 2;

template <typename T, int R>
__global__ void __launch_bounds__(1024)
ell_resident_rows(const T* __restrict__ vals, const int* __restrict__ cols,
                  const T* __restrict__ g, T* __restrict__ y, int64_t Lrow,
                  int W, int64_t G, int64_t gcols, int64_t g_stride, int tpr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const int s = blockIdx.y;
  const T* gs = g + (int64_t)s * g_stride;
  for (int64_t j = threadIdx.x; j < G; j += blockDim.x)
    xs[j] = (j < gcols) ? gs[j] : T(0);
  __syncthreads();

  const int rows_per_pass = blockDim.x / tpr;   // rows of one of the R passes
  const int lane = threadIdx.x % tpr;
  const T* vs = vals + (int64_t)s * Lrow * W;
  const int* cs = cols + (int64_t)s * Lrow * W;
  T* ys = y + (int64_t)s * Lrow;
  // every thread of the block runs the same number of iterations, so the
  // whole warp reaches the shuffles
  for (int64_t row0 = (int64_t)blockIdx.x * rows_per_pass * R; row0 < Lrow;
       row0 += (int64_t)gridDim.x * rows_per_pass * R) {
    int64_t row[R];
    T acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      row[k] = row0 + k * rows_per_pass + threadIdx.x / tpr;
      acc[k] = T(0);
    }
    for (int w = lane; w < W; w += tpr) {
      int c[R];
      T v[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const bool live = row[k] < Lrow;
        c[k] = live ? cs[row[k] * W + w] : 0;
        v[k] = live ? vs[row[k] * W + w] : T(0);
      }
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] += v[k] * xs[c[k]];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      for (int o = tpr / 2; o > 0; o >>= 1)
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], o, tpr);
      if (lane == 0 && row[k] < Lrow) ys[row[k]] = acc[k];
    }
  }
}

template <typename T>
__global__ void ell_resident_tail(const T* __restrict__ tvals,
                                  const int* __restrict__ trows,
                                  const int* __restrict__ tgidx,
                                  const T* __restrict__ g, T* __restrict__ y,
                                  int64_t Lrow, int64_t Tpad, int64_t gcols,
                                  int64_t g_stride) {
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
static int static_smem(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, ell_resident_rows<T, kRowsPerPass>);
  *out = (int)a.sharedSizeBytes;
  return (int)e;
}

template <typename T>
static int launch(const void* vals, const void* cols, const void* tvals,
                  const void* trows, const void* tgidx, const void* g, void* y,
                  int64_t S, int64_t Lrow, int W, int64_t Tpad, int64_t G,
                  int64_t gcols, int64_t g_stride, int tpr, int threads,
                  void* stream) {
  if (S < 1 || S > 65535 || Lrow < 1 || W < 1 || G < 1 || tpr < 1 ||
      tpr > 32 || (tpr & (tpr - 1)) || threads % 32 || threads % tpr ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  auto* kernel = ell_resident_rows<T, kRowsPerPass>;
  const size_t smem = (size_t)G * sizeof(T);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  // persistent grid: the blocks the card holds at once, shared among the
  // shards, and no more than the row tiles of a shard
  const int64_t rows_per_iter = (int64_t)(threads / tpr) * kRowsPerPass;
  const int64_t tiles = (Lrow + rows_per_iter - 1) / rows_per_iter;
  int64_t per_shard = ((int64_t)sms * occ) / S;
  if (per_shard < 1) per_shard = 1;
  if (per_shard > tiles) per_shard = tiles;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)per_shard, (unsigned)S);
  kernel<<<grid, threads, smem, st>>>((const T*)vals, (const int*)cols,
                                      (const T*)g, (T*)y, Lrow, W, G, gcols,
                                      g_stride, tpr);
  if (Tpad > 0) {
    const int tt = 256;
    dim3 tgrid((unsigned)((Tpad + tt - 1) / tt), (unsigned)S);
    ell_resident_tail<T><<<tgrid, tt, 0, st>>>(
        (const T*)tvals, (const int*)trows, (const int*)tgidx, (const T*)g,
        (T*)y, Lrow, Tpad, gcols, g_stride);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// The largest G * sizeof(T) a launch may stage on `device`: the opt-in
// maximum of dynamic shared memory per block, less the kernel's own static
// shared memory. Returns a negative cudaError_t on failure.
int64_t ell_resident_smem_cap(int device) {
  int optin = 0, s32 = 0, s64 = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int64_t)e;
  int rc = static_smem<float>(&s32);
  if (rc == 0) rc = static_smem<double>(&s64);
  if (rc != 0) return -(int64_t)rc;
  return (int64_t)optin - (s32 > s64 ? s32 : s64);
}

// Tpad == 0 means no tail (tvals/trows/tgidx are then not read). G is the
// number of gathered slots staged; slots gcols..G-1 stage as 0.
// Returns cudaGetLastError() after the launches.
int ell_resident_spmv_f32(const void* vals, const void* cols, const void* tvals,
                          const void* trows, const void* tgidx, const void* g,
                          void* y, int64_t S, int64_t Lrow, int W, int64_t Tpad,
                          int64_t G, int64_t gcols, int64_t g_stride, int tpr,
                          int threads, void* stream) {
  return launch<float>(vals, cols, tvals, trows, tgidx, g, y, S, Lrow, W, Tpad,
                       G, gcols, g_stride, tpr, threads, stream);
}

int ell_resident_spmv_f64(const void* vals, const void* cols, const void* tvals,
                          const void* trows, const void* tgidx, const void* g,
                          void* y, int64_t S, int64_t Lrow, int W, int64_t Tpad,
                          int64_t G, int64_t gcols, int64_t g_stride, int tpr,
                          int threads, void* stream) {
  return launch<double>(vals, cols, tvals, trows, tgidx, g, y, S, Lrow, W, Tpad,
                        G, gcols, g_stride, tpr, threads, stream);
}

}  // extern "C"
