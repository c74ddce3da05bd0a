// K3: ELL SpMV with x read from shared memory, for Hopper. All stacked
// shards run in one launch (blockIdx.y is the shard).
//
//   y[s, r]  = sum_{w < len[s, r]} vals[s, r, w] * g[s, cols[s, r, w]]
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
// Bound: bytes, as K2's (the stored entries, the row-length table, x once,
// y once). Design. A row tile is `passes` passes of K2's row layout
// (csrc/ell_common.cuh), kRowThreads / TPR rows each; the plan picks the
// tile height (ops/cuda_ell_resident.py tile_rows) and records, for each
// tile, the column window [lo, hi) its stored entries read. A block stages
// only that window, widened to 16-byte ends, with cp.async into one of two
// buffers, and issues the next tile's staging before it sums the current
// one, and its first rows' table loads before it waits on the window. A
// banded matrix thus stages a few KB a tile, and enough blocks fit on an SM
// to hide HBM latency (the first K3 staged the whole x, 131 KB for the
// ridge path's normal matrix, in every block). When two windows do not fit
// the shared memory a block may take (a random pattern at the cap), the
// block stages the whole gathered x once, with cp.async while its first
// rows' table loads are in flight, and walks its tiles on it. Rows are
// summed by K2's row pass, so without a tail K3 and K2 agree bit for bit;
// the tail is K2's segmented tail kernel, whose atomics sum in no fixed
// order. Values are f32, f64, c64 or c128 (csrc/values.cuh), one
// instantiation each: a staged complex window takes twice the bytes of its
// real parts' (a c128 slot is 16 bytes), so the plan stages windows and
// picks this engine by the complex item size (ops/cuda_ell_resident.py
// make_windows, ops/spmv.py SpMVPlan.engine).

#include "ell_common.cuh"

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x from a staged window whose first slot is column lo
template <typename T>
struct SharedX {
  const T* xs;
  int lo;
  __device__ __forceinline__ T operator()(int c) const { return xs[c - lo]; }
};

// wait for the window staged into the buffer about to be read
struct WindowWait {
  bool more;   // another tile's window is in flight behind this one
  __device__ __forceinline__ void operator()() const {
    if (more)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
  }
};

// Stage columns [lo, hi) of gs, both ends widened to 16 bytes, into buf;
// columns >= gcols stage as 0. Returns the first staged column.
template <typename T>
__device__ __forceinline__ int stage_window(T* buf, const T* __restrict__ gs,
                                            int lo, int hi, int64_t gcols,
                                            bool aligned) {
  constexpr int V = kVec<T>;
  const int a = lo & ~(V - 1);
  const int b = (hi + V - 1) & ~(V - 1);
  for (int c = a + (int)threadIdx.x * V; c < b; c += (int)blockDim.x * V) {
    T* dst = buf + (c - a);
    if (aligned && c + V <= gcols) {
      cp_async16(dst, gs + c);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = (c + i < gcols) ? gs[c + i] : T(0);
    }
  }
  cp_async_commit();
  return a;
}

constexpr int kWholeThreads = 1024;   // whole-x staging: one block an SM

// The rows of tile t: `passes` row passes of the block's groups; wait() on
// the first pass only (the window is staged once for the tile).
template <typename T, int VEC, typename XRead, typename Wait>
__device__ __forceinline__ void rows_of_tile(
    const T* vs, const int* cs, const int* ls, T* ys, int64_t Lrow, int W,
    int64_t base, int groups, int passes, int group, int lane, int tpr_log2,
    const XRead& xr, const Wait& wait) {
  ell_row_pass<T, VEC>(vs, cs, ls, ys, Lrow, W, base, group, lane, tpr_log2,
                       xr, wait);
  for (int p = 1; p < passes; ++p)
    ell_row_pass<T, VEC>(vs, cs, ls, ys, Lrow, W, base + (int64_t)p * groups,
                         group, lane, tpr_log2, xr, NoWait{});
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWholeThreads)
ell_resident_rows(const T* __restrict__ vals, const int* __restrict__ cols,
                  const int* __restrict__ rowlen,
                  const int* __restrict__ windows, const T* __restrict__ g,
                  T* __restrict__ y, int64_t Lrow, int W, int64_t G,
                  int64_t gcols, int64_t g_stride, int tpr_log2, int passes,
                  int64_t ntiles, int win_cap, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const int s = blockIdx.y;
  const int groups = blockDim.x >> tpr_log2;
  const int group = threadIdx.x >> tpr_log2;
  const int lane = threadIdx.x & ((1 << tpr_log2) - 1);
  const int64_t off = (int64_t)s * Lrow;
  const T* vs = vals + off * W;
  const int* cs = cols + off * W;
  const int* ls = rowlen + off;
  T* ys = y + off;
  const T* gs = g + (int64_t)s * g_stride;
  const int64_t tile = (int64_t)groups * passes;
  // the grid has no more blocks than tiles, and t is the same for the whole
  // block: every thread reaches the barriers

  if (win_cap == 0) {
    // the whole x once per block, staged while the first rows' table loads
    // are in flight, then every tile of the block on it
    stage_window<T>(xs, gs, 0, (int)G, gcols, aligned);
    const SharedX<T> xr{xs, 0};
    int64_t t = blockIdx.x;
    rows_of_tile<T, VEC>(vs, cs, ls, ys, Lrow, W, t * tile, groups, passes,
                         group, lane, tpr_log2, xr, WindowWait{false});
    for (t += gridDim.x; t < ntiles; t += gridDim.x)
      rows_of_tile<T, VEC>(vs, cs, ls, ys, Lrow, W, t * tile, groups, passes,
                           group, lane, tpr_log2, xr, NoWait{});
    return;
  }

  const int* wt = windows + (int64_t)s * ntiles * 2;
  int64_t t = blockIdx.x;
  int buf = 0;
  int lo = stage_window<T>(xs, gs, __ldg(wt + 2 * t), __ldg(wt + 2 * t + 1),
                           gcols, aligned);
  for (; t < ntiles; t += gridDim.x) {
    const int64_t tn = t + gridDim.x;
    int lo_next = 0;
    if (tn < ntiles)
      lo_next = stage_window<T>(xs + (buf ^ 1) * win_cap, gs,
                                __ldg(wt + 2 * tn), __ldg(wt + 2 * tn + 1),
                                gcols, aligned);
    rows_of_tile<T, VEC>(vs, cs, ls, ys, Lrow, W, t * tile, groups, passes,
                         group, lane, tpr_log2,
                         SharedX<T>{xs + buf * win_cap, lo},
                         WindowWait{tn < ntiles});
    __syncthreads();   // the buffer is read out before it is staged again
    buf ^= 1;
    lo = lo_next;
  }
}

// The shared-memory opt-in of ell_resident_rows<T, VEC> and the card's SMs
// and resident blocks at this launch shape, queried once per device and
// shape: the launch does not repeat the runtime calls (one stream at a time
// calls a launcher). Each <T, VEC> has its own cache, as each kernel needs
// its own opt-in.
template <typename T, int VEC>
static cudaError_t configure(int threads, size_t smem, int* sms, int* occ) {
  static int c_dev = -1, c_threads = 0, c_sms = 0, c_occ = 0;
  static size_t c_smem = 0;
  auto* kernel = ell_resident_rows<T, VEC>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != c_dev || threads != c_threads || smem != c_smem) {
    e = cudaDeviceGetAttribute(&c_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c_occ, kernel,
                                                        threads, smem);
    if (e != cudaSuccess) {
      c_dev = -1;
      return e;
    }
    c_dev = dev;
    c_threads = threads;
    c_smem = smem;
  }
  *sms = c_sms;
  *occ = c_occ;
  return cudaSuccess;
}

template <typename T, int VEC>
static int launch_rows(const void* vals, const void* cols, const void* rowlen,
                       const void* windows, const void* g, void* y, int64_t S,
                       int64_t Lrow, int W, int64_t G, int64_t gcols,
                       int64_t g_stride, int tpr_log2, int passes, int win_cap,
                       int aligned, cudaStream_t st) {
  // windows: kRowThreads a block, several blocks an SM; the whole x: one
  // block an SM, as many threads as a block may have
  const int threads = win_cap ? kRowThreads : kWholeThreads;
  const int64_t tile = (int64_t)(threads >> tpr_log2) * passes;
  const int64_t ntiles = (Lrow + tile - 1) / tile;
  constexpr int V = kVec<T>;
  const size_t smem = (size_t)(win_cap ? 2 * (int64_t)win_cap
                                       : (G + V - 1) / V * V) * sizeof(T);
  int sms = 0, occ = 0;
  const cudaError_t e = configure<T, VEC>(threads, smem, &sms, &occ);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  // persistent grid: the blocks the card holds at once, shared among the
  // shards, and no more than the row tiles of a shard
  int64_t per_shard = ((int64_t)sms * occ) / S;
  if (per_shard < 1) per_shard = 1;
  if (per_shard > ntiles) per_shard = ntiles;
  dim3 grid((unsigned)per_shard, (unsigned)S);
  ell_resident_rows<T, VEC><<<grid, threads, smem, st>>>(
      (const T*)vals, (const int*)cols, (const int*)rowlen,
      (const int*)windows, (const T*)g, (T*)y, Lrow, W, G, gcols, g_stride,
      tpr_log2, passes, ntiles, win_cap, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* vals, const void* cols, const void* rowlen,
                  const void* windows, const void* tvals, const void* trows,
                  const void* tgidx, const void* g, void* y, int64_t S,
                  int64_t Lrow, int W, int64_t Tpad, int64_t G, int64_t gcols,
                  int64_t g_stride, int tpr, int vec, int64_t tile_rows,
                  int win_cap, int aligned, void* stream) {
  constexpr int V = kVec<T>;
  const int64_t groups = tpr >= 1 ? kRowThreads / tpr : 0;
  if (rowlen == nullptr || S < 1 || S > 65535 || Lrow < 1 || W < 1 ||
      G < 1 || G > (1 << 30) || tpr < 1 || tpr > 32 || (tpr & (tpr - 1)) ||
      (vec != 1 && vec != V) || W % vec || Tpad % kTailPerThread ||
      win_cap < 0 || tile_rows < groups || tile_rows % groups ||
      (win_cap > 0 && (windows == nullptr || win_cap % 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int l2 = log2_pow2(tpr);
  const int passes = (int)(tile_rows / groups);
  const int rc =
      vec == V ? launch_rows<T, V>(vals, cols, rowlen, windows, g, y, S, Lrow,
                                   W, G, gcols, g_stride, l2, passes, win_cap,
                                   aligned, st)
               : launch_rows<T, 1>(vals, cols, rowlen, windows, g, y, S, Lrow,
                                   W, G, gcols, g_stride, l2, passes, win_cap,
                                   aligned, st);
  if (rc != 0) return rc;
  if (Tpad > 0)
    launch_tail<T>(tvals, trows, tgidx, g, y, S, Lrow, Tpad, gcols, g_stride, st);
  return (int)cudaGetLastError();
}

template <typename T>
static int static_smem(int* out) {
  int worst = 0;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, ell_resident_rows<T, kVec<T>>);
  if (e == cudaSuccess) {
    worst = (int)a.sharedSizeBytes;
    e = cudaFuncGetAttributes(&a, ell_resident_rows<T, 1>);
  }
  if (e == cudaSuccess && (int)a.sharedSizeBytes > worst)
    worst = (int)a.sharedSizeBytes;
  *out = worst;
  return (int)e;
}

extern "C" {

// The largest staging in bytes a launch may use on `device`: the opt-in
// maximum of dynamic shared memory per block, less the largest static
// shared memory of the kernel's instantiations. Returns a negative
// cudaError_t on failure.
int64_t ell_resident_smem_cap(int device) {
  int optin = 0, worst = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int64_t)e;
  int (*const each[])(int*) = {static_smem<float>, static_smem<double>,
                               static_smem<c64>, static_smem<c128>};
  for (auto f : each) {
    int s = 0;
    const int rc = f(&s);
    if (rc != 0) return -(int64_t)rc;
    if (s > worst) worst = s;
  }
  return (int64_t)optin - worst;
}

// rowlen: (S, Lrow) stored row lengths. windows: (S, ntiles, 2) int32
// [lo, hi) per tile of tile_rows rows (whole passes of kRowThreads / tpr
// rows), used when win_cap > 0 (elements per buffer, two buffers);
// win_cap == 0 stages the whole gathered x, G slots (slots gcols..G-1 stage
// as 0). aligned != 0: g and its shard stride are 16-byte aligned. Tpad == 0
// means no tail. The _c64 / _c128 entry points take torch's interleaved
// complex64 / complex128 values, x and y. Returns cudaGetLastError() after
// the launches.
#define ELL_RESIDENT_ENTRY(NAME, T)                                           \
  int NAME(const void* vals, const void* cols, const void* rowlen,           \
           const void* windows, const void* tvals, const void* trows,        \
           const void* tgidx, const void* g, void* y, int64_t S,             \
           int64_t Lrow, int W, int64_t Tpad, int64_t G, int64_t gcols,      \
           int64_t g_stride, int tpr, int vec, int64_t tile_rows,            \
           int win_cap, int aligned, void* stream) {                         \
    return launch<T>(vals, cols, rowlen, windows, tvals, trows, tgidx, g, y, \
                     S, Lrow, W, Tpad, G, gcols, g_stride, tpr, vec,         \
                     tile_rows, win_cap, aligned, stream);                   \
  }

ELL_RESIDENT_ENTRY(ell_resident_spmv_f32, float)
ELL_RESIDENT_ENTRY(ell_resident_spmv_f64, double)
ELL_RESIDENT_ENTRY(ell_resident_spmv_c64, c64)
ELL_RESIDENT_ENTRY(ell_resident_spmv_c128, c128)

}  // extern "C"
