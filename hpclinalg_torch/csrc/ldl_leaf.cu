// The base case of the device LDL^T (hpclinalg_torch/solver/device_mf.py
// batched_ldl): the unpivoted LDL^T, with the plain transpose (also for
// complex-symmetric blocks: never the conjugate), of a whole batch of
// n x n diagonal blocks, n <= LDL_LEAF, in one launch:
//
//   for k = 0 .. n-1:
//     d_k = A[k,k], clamped: |d_k| < eps -> sign(Re d_k) eps (counted)
//     L[i,k] = A[i,k] / d_k                              (i > k)
//     A[i,j] -= L[i,k] A[j,k]                            (k < j <= i)
//
// writing unit-lower L (exact zeros above the diagonal, ones on it), d and
// the count of clamped pivots, added into one int64 counter. The clamp is
// device_mf._clamp's; eps is read from a 0-d device tensor at run time, so
// a captured graph replays with the threshold of each factorization.
//
// Replaces no TPU kernel: the JAX engine (hpclinalg/solver/device_mf.py
// batched_ldl) recurses to 1 x 1 blocks and XLA fuses the recursion's
// bookkeeping. The port's plain recursion launched about eight kernels at
// each 1 x 1 leaf and ten at each split, so the factor graph of a 512^2
// Helmholtz operator held 151,990 nodes, nearly all of them bookkeeping.
// Bound: latency, not arithmetic or bytes (n^3/6 multiply-adds a block,
// its lower triangle read and L and d written once), except in the widest
// batches, where the rows' strided loads and stores bound it. Design:
//   * A group of G lanes a block (G = 8, 16 or 32, the least that holds n),
//     LDL_THREADS / G groups a thread block; lane i holds row i of the
//     block's lower triangle in registers (every index into it is a
//     constant of the unrolled loops).
//   * Column k goes through shared memory: each lane i >= k writes its
//     A[i,k], one __syncwarp, then every lane reads the pivot and the
//     column by broadcast. Two column buffers alternate, so one barrier a
//     column is enough (the buffer written at k was last read at k - 2).
//   * The columns run in series, so a column's critical path is what the
//     kernel is made of: a column's step is the same branch-free code in
//     every lane, so the unrolled multiply-adds of one column overlap (a
//     lane updates its whole row past column k, the entries past its
//     diagonal being never read), and the column is scaled by the pivot's
//     reciprocal, one division a column (a complex pivot scaled by a power
//     of two first, exactly, which |d| < eps reuses). On an H100 one
//     32-column c128 block takes 18.0 us a launch so, 27.4 with a branch
//     an update and a complex division an entry.
//   * Input and outputs through their batch, row and column strides: the
//     input is a view into the (S, B, NF, NF) front buffer, the outputs
//     views into the recursion's L and d (ops/cuda_ldl.py collapses the
//     batch axes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "values.cuh"

#define LDL_THREADS 128
#define LDL_LEAF 32

template <typename T> struct RealOf { using type = T; };
template <> struct RealOf<c64> { using type = float; };
template <> struct RealOf<c128> { using type = double; };

// ---- what the clamp and the pivot's reciprocal need of each type -----------
__device__ __forceinline__ float re(float v) { return v; }
__device__ __forceinline__ double re(double v) { return v; }
__device__ __forceinline__ float re(c64 v) { return v.re; }
__device__ __forceinline__ double re(c128 v) { return v.re; }

__device__ __forceinline__ float neg(float v) { return -v; }
__device__ __forceinline__ double neg(double v) { return -v; }
__device__ __forceinline__ c64 neg(c64 v) { return c64(-v.re, -v.im); }
__device__ __forceinline__ c128 neg(c128 v) { return c128(-v.re, -v.im); }

// Whether |v| < eps, and 1 / v into inv: one division. A complex v = c +
// id is scaled by 2^-e first, e the exponent of max(|c|, |d|) (exact, from
// the bits), so c^2 + d^2 lies in [1, 8): neither it nor the comparison
// with (eps 2^-e)^2 overflows or underflows where the answer depends on
// it. v = 0 gives an inf or nan, as a division by zero does.
__device__ __forceinline__ bool below_recip(float v, float eps, float& inv) {
  inv = 1.f / v;
  return fabsf(v) < eps;
}
__device__ __forceinline__ bool below_recip(double v, double eps,
                                            double& inv) {
  inv = 1.0 / v;
  return fabs(v) < eps;
}
__device__ __forceinline__ bool below_recip(c64 v, float eps, c64& inv) {
  const int bits = __float_as_int(fmaxf(fabsf(v.re), fabsf(v.im))) &
                   0x7f800000;
  const float sc = __int_as_float(0x7f000000 - bits);  // 2^-e
  const float c = v.re * sc, d = v.im * sc, n2 = c * c + d * d;
  const float s = sc / n2, e = eps * sc;
  inv = c64(c * s, -d * s);
  return n2 < e * e;
}
__device__ __forceinline__ bool below_recip(c128 v, double eps, c128& inv) {
  const long long bits =
      __double_as_longlong(fmax(fabs(v.re), fabs(v.im))) &
      0x7ff0000000000000LL;
  const double sc = __longlong_as_double(0x7fe0000000000000LL - bits);
  const double c = v.re * sc, d = v.im * sc, n2 = c * c + d * d;
  const double s = sc / n2, e = eps * sc;
  inv = c128(c * s, -d * s);
  return n2 < e * e;
}

// ---- the kernel -------------------------------------------------------------
template <typename T, int G>
__global__ void __launch_bounds__(LDL_THREADS)
    ldl_leaf(const T* __restrict__ A, int64_t nb, int n, int64_t sab,
             int64_t sar, int64_t sac, T* __restrict__ L, int64_t slb,
             int64_t slr, int64_t slc, T* __restrict__ D, int64_t sdb,
             int64_t sdc, const typename RealOf<T>::type* __restrict__ eps_p,
             unsigned long long* __restrict__ count) {
  using R = typename RealOf<T>::type;
  constexpr int GROUPS = LDL_THREADS / G;
  // two column buffers a group: [2][GROUPS][G] entries
  __shared__ __align__(16) unsigned char col_raw[2 * GROUPS * G * sizeof(T)];
  T* const col = reinterpret_cast<T*>(col_raw);
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int64_t b = (int64_t)blockIdx.x * GROUPS + grp;
  const bool live = b < nb && lane < n;
  const R eps = *eps_p;

  // row `lane` of the lower triangle; zeros past it and in dead lanes
  T a[G];
  const T* Ar = A + (live ? b * sab + (int64_t)lane * sar : 0);
#pragma unroll
  for (int j = 0; j < G; ++j) a[j] = live && j <= lane ? Ar[j * sac] : T(0);

  int clamped = 0;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= n) break;  // the same n in every lane of the launch
    T* w = col + ((k & 1) * GROUPS + grp) * G;
    if (lane >= k) w[lane] = a[k];
    __syncwarp();
    T d = w[k], inv;
    if (below_recip(d, eps, inv)) {
      d = T(re(d) >= R(0) ? eps : -eps);
      below_recip(d, eps, inv);
      ++clamped;
    }
    // every lane runs the same code: past its diagonal (lane <= k, or
    // j > lane) it updates entries of its row's upper part, never read
    const T l = mul(a[k], inv);
    a[k] = lane == k ? d : lane > k ? l : a[k];
    const T ml = neg(l);
#pragma unroll
    for (int j = k + 1; j < G; ++j) a[j] = mad(a[j], ml, w[j]);
  }

  if (live) {
    T* Lr = L + b * slb + (int64_t)lane * slr;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= n) break;
      Lr[j * slc] = j < lane ? a[j] : T(j == lane ? 1 : 0);
      if (j == lane) D[b * sdb + (int64_t)lane * sdc] = a[j];
    }
    if (lane == 0 && clamped)
      atomicAdd(count, (unsigned long long)clamped);
  }
}

// ---- launches -----------------------------------------------------------
template <typename T, int G>
static int launch(const void* A, int64_t nb, int n, const int64_t* sa,
                  void* L, const int64_t* sl, void* D, const int64_t* sd,
                  const void* eps, void* count, void* stream) {
  constexpr int GROUPS = LDL_THREADS / G;
  const int64_t blocks = (nb + GROUPS - 1) / GROUPS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ldl_leaf<T, G><<<(unsigned)blocks, LDL_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)A, nb, n, sa[0], sa[1], sa[2], (T*)L, sl[0], sl[1], sl[2],
      (T*)D, sd[0], sd[1], (const typename RealOf<T>::type*)eps,
      (unsigned long long*)count);
  return (int)cudaGetLastError();
}

template <typename T>
static int ldl(const void* A, int64_t nb, int n, const int64_t* sa, void* L,
               const int64_t* sl, void* D, const int64_t* sd, const void* eps,
               void* count, void* stream) {
  if (nb < 0 || n < 1 || n > LDL_LEAF) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  if (n <= 8) return launch<T, 8>(A, nb, n, sa, L, sl, D, sd, eps, count, stream);
  if (n <= 16)
    return launch<T, 16>(A, nb, n, sa, L, sl, D, sd, eps, count, stream);
  return launch<T, 32>(A, nb, n, sa, L, sl, D, sd, eps, count, stream);
}

extern "C" {

// A: nb blocks of n x n (1 <= n <= LDL_LEAF), entry (b, i, j) at
// A + b sa[0] + i sa[1] + j sa[2] (strides in entries), read in its lower
// triangle only; L (nb, n, n) and D (nb, n) likewise through sl and sd;
// eps: one value of T's real type on the device; count: one int64 on the
// device, to which the clamped pivots are added. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a bad n or batch).
#define LDL_LEAF_ENTRY(SUFFIX, T)                                            \
  int ldl_leaf_##SUFFIX(const void* A, int64_t nb, int n, const int64_t* sa, \
                        void* L, const int64_t* sl, void* D,                 \
                        const int64_t* sd, const void* eps, void* count,     \
                        void* stream) {                                      \
    return ldl<T>(A, nb, n, sa, L, sl, D, sd, eps, count, stream);           \
  }

LDL_LEAF_ENTRY(f32, float)
LDL_LEAF_ENTRY(f64, double)
LDL_LEAF_ENTRY(c64, c64)
LDL_LEAF_ENTRY(c128, c128)

// The most columns of a block the entry points take (LDL_LEAF), which
// ops/cuda_ldl.py checks against its LEAF when it loads the library.
int ldl_leaf_cols(void) { return LDL_LEAF; }

}  // extern "C"
