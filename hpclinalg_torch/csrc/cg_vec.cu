// The CG step's vector work between one SpMV and the next, in three passes
// over the step's flat (nlocal * Lrow) vectors (hpclinalg_torch/entry.py
// cg_step_fn):
//
//   cg_dots       dots = (p . Ap, r . r)
//   cg_update_xr  alpha = dots[1] / dots[0]; x' = x + alpha p;
//                 r' = r - alpha Ap; rr = r' . r'
//   cg_update_p   beta = rr / dots[1]; p' = r' + beta p
//
// with the step's collectives between them (dots and rr are all_reduced on
// a process group). Textbook CG's three-dot step (__graft_entry__.py
// _cg_step_fn), in f32 and f64.
//
// Replaces no TPU kernel: the JAX step leaves this work to XLA. The port's
// plain step ran it as eleven PyTorch launches (three scalings into
// temporaries, three adds, three cuBLAS dots with a second reduction kernel
// each, two divisions), about 171 MB of traffic a step at HPCG's 1.1M rows.
// Bound: device-memory bytes, 108 MB there: cg_dots reads p, Ap and r;
// cg_update_xr reads x, r, p and Ap and writes x and r; cg_update_p reads
// r and p and writes p. Design:
//   * A thread walks units of W = 16 / sizeof(T) consecutive entries, unit
//     u of the grid-stride walk at entries [u W, u W + W): a whole unit is
//     one 16-byte access, the last, partial one W guarded scalar accesses.
//     Every pointer is 16-byte aligned (ops/cuda_cg.py refuses others).
//   * Deterministic reductions: the grid is fixed by the vector's length
//     and the device (ops/cuda_cg.py grid_blocks), each block reduces its
//     threads' sums in a fixed tree (warp shuffles, then one warp over the
//     warps) and writes its partial to a workspace; the last block to
//     finish, found by an atomic ticket that it resets, sums the partials
//     in a fixed order. A replay equals an eager step bit for bit.
//   * Dots accumulate in double (f32 entries widened before the product).
//   * alpha and beta are divided in T in each block, from the reduced
//     dots, and the updates round product, then sum (the _rn intrinsics are
//     never contracted into an FMA): the arithmetic of the plain step's
//     `x + alpha * p`.
//   * x' may be x, r' may be r and p' may be p: each entry is read, then
//     written, by the one thread that owns it, so no pointer is __restrict__.

#include <cuda_runtime.h>
#include <stdint.h>

#define CG_THREADS 256
#define CG_WARPS (CG_THREADS / 32)

constexpr unsigned kFull = 0xffffffffu;

template <typename T>
constexpr int kW = 16 / (int)sizeof(T);

// ---- one unit of W entries: a 16-byte access or W scalar ones -------------
__device__ __forceinline__ void load(const float* p, int64_t i, int64_t n,
                                     float (&v)[4]) {
  if (i + 4 <= n) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = i + k < n ? p[i + k] : 0.f;
}

__device__ __forceinline__ void load(const double* p, int64_t i, int64_t n,
                                     double (&v)[2]) {
  if (i + 2 <= n) {
    const double2 q = *reinterpret_cast<const double2*>(p + i);
    v[0] = q.x; v[1] = q.y;
    return;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) v[k] = i + k < n ? p[i + k] : 0.0;
}

__device__ __forceinline__ void store(float* p, int64_t i, int64_t n,
                                      const float (&v)[4]) {
  if (i + 4 <= n) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < n) p[i + k] = v[k];
}

__device__ __forceinline__ void store(double* p, int64_t i, int64_t n,
                                      const double (&v)[2]) {
  if (i + 2 <= n) {
    *reinterpret_cast<double2*>(p + i) = make_double2(v[0], v[1]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (i + k < n) p[i + k] = v[k];
}

// ---- a + s * b and a - s * b, each rounded as product, then sum ---------
__device__ __forceinline__ float axpy(float a, float s, float b) {
  return __fadd_rn(a, __fmul_rn(s, b));
}
__device__ __forceinline__ double axpy(double a, double s, double b) {
  return __dadd_rn(a, __dmul_rn(s, b));
}
__device__ __forceinline__ float axmy(float a, float s, float b) {
  return __fsub_rn(a, __fmul_rn(s, b));
}
__device__ __forceinline__ double axmy(double a, double s, double b) {
  return __dsub_rn(a, __dmul_rn(s, b));
}

// ---- deterministic reductions ---------------------------------------------
// The block's NV sums into thread 0, in a fixed tree. sm: NV * CG_WARPS.
template <int NV>
__device__ __forceinline__ void block_sum(double (&v)[NV], double* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(kFull, v[k], o);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < NV; ++k) sm[k * CG_WARPS + warp] = v[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v[k] = lane < CG_WARPS ? sm[k * CG_WARPS + lane] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v[k] += __shfl_down_sync(kFull, v[k], o);
    }
  }
}

// The grid's NV sums into out[0, NV): each block's partial goes to
// partials[k * gridDim.x + block]; the last block to take a ticket sums
// them in a fixed order and resets the ticket for the next launch.
template <int NV, typename T>
__device__ __forceinline__ void grid_sum(double (&v)[NV], double* partials,
                                         unsigned* ticket, T* out) {
  __shared__ double sm[NV * CG_WARPS];
  __shared__ bool last;
  block_sum<NV>(v, sm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) partials[k * gridDim.x + blockIdx.x] = v[k];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    s[k] = 0.0;
    for (unsigned b = threadIdx.x; b < gridDim.x; b += CG_THREADS)
      s[k] += __ldcg(partials + k * gridDim.x + b);
  }
  block_sum<NV>(s, sm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) out[k] = (T)s[k];
    *ticket = 0u;
  }
}

// ---- the kernels -----------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(CG_THREADS)
    cg_dots(const T* p, const T* Ap, const T* r, int64_t n, double* partials,
            unsigned* ticket, T* dots) {
  constexpr int W = kW<T>;
  double v[2] = {0.0, 0.0};
  const int64_t units = (n + W - 1) / W;
  for (int64_t u = blockIdx.x * (int64_t)CG_THREADS + threadIdx.x; u < units;
       u += (int64_t)gridDim.x * CG_THREADS) {
    T a[W], b[W], c[W];
    load(p, u * W, n, a);
    load(Ap, u * W, n, b);
    load(r, u * W, n, c);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v[0] += (double)a[k] * (double)b[k];
      v[1] += (double)c[k] * (double)c[k];
    }
  }
  grid_sum<2>(v, partials, ticket, dots);
}

template <typename T>
__global__ void __launch_bounds__(CG_THREADS)
    cg_update_xr(const T* x, const T* r, const T* p, const T* Ap, T* xo,
                 T* ro, const T* dots, int64_t n, double* partials,
                 unsigned* ticket, T* rr) {
  constexpr int W = kW<T>;
  const T alpha = dots[1] / dots[0];
  double v[1] = {0.0};
  const int64_t units = (n + W - 1) / W;
  for (int64_t u = blockIdx.x * (int64_t)CG_THREADS + threadIdx.x; u < units;
       u += (int64_t)gridDim.x * CG_THREADS) {
    T a[W], b[W], c[W], d[W];
    load(x, u * W, n, a);
    load(r, u * W, n, b);
    load(p, u * W, n, c);
    load(Ap, u * W, n, d);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      a[k] = axpy(a[k], alpha, c[k]);
      b[k] = axmy(b[k], alpha, d[k]);
      v[0] += (double)b[k] * (double)b[k];
    }
    store(xo, u * W, n, a);
    store(ro, u * W, n, b);
  }
  grid_sum<1>(v, partials, ticket, rr);
}

template <typename T>
__global__ void __launch_bounds__(CG_THREADS)
    cg_update_p(const T* r, const T* p, T* po, const T* dots, const T* rr,
                int64_t n) {
  constexpr int W = kW<T>;
  const T beta = rr[0] / dots[1];
  const int64_t units = (n + W - 1) / W;
  for (int64_t u = blockIdx.x * (int64_t)CG_THREADS + threadIdx.x; u < units;
       u += (int64_t)gridDim.x * CG_THREADS) {
    T a[W], b[W];
    load(r, u * W, n, a);
    load(p, u * W, n, b);
#pragma unroll
    for (int k = 0; k < W; ++k) a[k] = axpy(a[k], beta, b[k]);
    store(po, u * W, n, a);
  }
}

// ---- launches -----------------------------------------------------------
static bool bad(int64_t n, int grid) {
  return n < 0 || grid < 1 || grid > (1 << 20);
}

template <typename T>
static int dots(const void* p, const void* Ap, const void* r, int64_t n,
                int grid, void* partials, void* ticket, void* out,
                void* stream) {
  if (bad(n, grid)) return (int)cudaErrorInvalidValue;
  cg_dots<T><<<grid, CG_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)p, (const T*)Ap, (const T*)r, n, (double*)partials,
      (unsigned*)ticket, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int update_xr(const void* x, const void* r, const void* p,
                     const void* Ap, void* xo, void* ro, const void* dts,
                     int64_t n, int grid, void* partials, void* ticket,
                     void* rr, void* stream) {
  if (bad(n, grid)) return (int)cudaErrorInvalidValue;
  cg_update_xr<T><<<grid, CG_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)r, (const T*)p, (const T*)Ap, (T*)xo, (T*)ro,
      (const T*)dts, n, (double*)partials, (unsigned*)ticket, (T*)rr);
  return (int)cudaGetLastError();
}

template <typename T>
static int update_p(const void* r, const void* p, void* po, const void* dts,
                    const void* rr, int64_t n, int grid, void* stream) {
  if (bad(n, grid)) return (int)cudaErrorInvalidValue;
  cg_update_p<T><<<grid, CG_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)p, (T*)po, (const T*)dts, (const T*)rr, n);
  return (int)cudaGetLastError();
}

extern "C" {

// n: the entries of each vector, each pointer 16-byte aligned; grid: the
// blocks (CG_THREADS threads each), the same for every launch of one
// workspace; partials: 2 * grid doubles; ticket: one unsigned, 0 before
// the first launch (each reducing launch leaves it 0); dots: (p . Ap,
// r . r) in T; rr: r' . r' in T. Each returns cudaGetLastError() after
// the launch.
#define CG_VEC_ENTRIES(SUFFIX, T)                                           \
  int cg_dots_##SUFFIX(const void* p, const void* Ap, const void* r,       \
                       int64_t n, int grid, void* partials, void* ticket,  \
                       void* dots_out, void* stream) {                     \
    return dots<T>(p, Ap, r, n, grid, partials, ticket, dots_out, stream); \
  }                                                                         \
  int cg_update_xr_##SUFFIX(const void* x, const void* r, const void* p,   \
                            const void* Ap, void* xo, void* ro,            \
                            const void* dts, int64_t n, int grid,          \
                            void* partials, void* ticket, void* rr,        \
                            void* stream) {                                \
    return update_xr<T>(x, r, p, Ap, xo, ro, dts, n, grid, partials,       \
                        ticket, rr, stream);                               \
  }                                                                         \
  int cg_update_p_##SUFFIX(const void* r, const void* p, void* po,         \
                           const void* dts, const void* rr, int64_t n,     \
                           int grid, void* stream) {                       \
    return update_p<T>(r, p, po, dts, rr, n, grid, stream);                \
  }

CG_VEC_ENTRIES(f32, float)
CG_VEC_ENTRIES(f64, double)

}  // extern "C"
