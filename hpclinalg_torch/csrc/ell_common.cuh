// Pieces shared by K2 (csrc/ell_spmv.cu) and K3 (csrc/ell_resident_spmv.cu):
// the row pass of the ELL SpMV and the segmented COO-tail kernel.
//
// Row pass. A group of TPR = 2^tpr_log2 neighbouring threads shares a row;
// each lane reads units of VEC consecutive entries (VEC = 16 bytes of
// values, kVec<T> entries, with their column indices in one load; VEC = 1
// when W is not a multiple, and always in c128), units lane, lane + TPR, ... of
// the row, so a warp's load covers consecutive bytes, and stops at the
// row's length, so the padding of the (Lrow, W) table is never fetched.
// The loop is software-pipelined: the table loads of a lane's next unit are
// issued before the x reads of its current one, so a step waits for one
// memory latency (table or x), not for both in turn. The plan picks TPR
// from the row lengths (ops/cuda_ell.py lanes_for), so short rows share a
// warp and long rows take more lanes. The row sum is a butterfly of
// shuffles inside the group, so K2 and K3 sum a row in the same order.
//
// Values. T is float, double, c64 or c128 (csrc/values.cuh): a unit is 16
// bytes of values in every type (4 f32, 2 f64, 2 c64, 1 c128 entries), and
// a complex entry is multiplied and added as four FMAs into its re and im
// accumulators; its shuffles and the tail's atomics go a component at a
// time (there is no complex atomicAdd).
//
// Tail. Entries of the COO tail come sorted by row within a shard (the plan
// emits them row by row). A thread takes kTailPerThread consecutive entries
// with vector loads, sums runs of equal rows itself and adds every run but
// its last with one atomicAdd each; the last runs of the warp's threads are
// combined by a segmented scan of shuffles keyed on the row, and each warp
// segment issues one atomicAdd. A row that spans many threads thus costs one
// atomic per warp instead of one per entry. Any order is summed correctly;
// sorted order keeps the atomics few. Rows equal to Lrow are the padding
// slots and are dropped.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "values.cuh"

constexpr int kRowThreads = 256;    // threads a block of the row kernels
constexpr int kRowBlocksPerSM = 4;  // register budget: 64 a thread
constexpr int kTailThreads = 256;
constexpr int kTailPerThread = 8;   // tail entries a thread: two int4 loads

template <typename T, int VEC>
struct Unit {
  int c[VEC];
  T v[VEC];
};

// the column indices of a unit of 2 or 4 entries, in one load
__device__ __forceinline__ void ldg_cols(const int* p, int (&c)[2]) {
  const int2 q = __ldg(reinterpret_cast<const int2*>(p));
  c[0] = q.x; c[1] = q.y;
}
__device__ __forceinline__ void ldg_cols(const int* p, int (&c)[4]) {
  const int4 q = __ldg(reinterpret_cast<const int4*>(p));
  c[0] = q.x; c[1] = q.y; c[2] = q.z; c[3] = q.w;
}

// a unit: one entry, or 16 bytes of values with their column indices (a
// c128 unit is one entry, so it takes the first branch, a 16-byte load)
template <typename T, int VEC>
__device__ __forceinline__ void load_unit(Unit<T, VEC>& u, const T* vp,
                                          const int* cp) {
  if constexpr (VEC == 1) {
    u.c[0] = __ldg(cp);
    u.v[0] = ldg1(vp);
  } else {
    static_assert(VEC == kVec<T>, "a unit is one entry or 16 bytes");
    ldg_cols(cp, u.c);
    ldg16(vp, u.v);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void zero_unit(Unit<T, VEC>& u) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    u.c[i] = 0;
    u.v[i] = T(0);
  }
}

// x through the read-only cache; columns >= gcols read as 0 (the zero
// padding of the JAX package's _pad_trunc)
template <typename T>
struct GlobalX {
  const T* g;
  int64_t gcols;
  __device__ __forceinline__ T operator()(int c) const {
    return c < gcols ? ldg1(g + c) : T(0);
  }
};

struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// One pass over row base + group of a shard (vs, cs, ls, ys already offset
// to the shard): the group's lanes sum the row and lane 0 writes it.
// ls holds each row's stored length. wait() is called by every thread once
// the first unit's table loads are issued and before any x read (K3 waits
// for its staged window there).
template <typename T, int VEC, typename XRead, typename Wait>
__device__ __forceinline__ void ell_row_pass(
    const T* __restrict__ vs, const int* __restrict__ cs,
    const int* __restrict__ ls, T* __restrict__ ys, int64_t Lrow, int W,
    int64_t base, int group, int lane, int tpr_log2, const XRead& xread,
    const Wait& wait) {
  const int64_t row = base + group;
  const int len = row < Lrow ? __ldg(ls + row) : 0;
  const T* vr = vs + row * W;
  const int* cr = cs + row * W;
  const int step = VEC << tpr_log2;
  int e = lane * VEC;
  T acc = T(0);
  Unit<T, VEC> u;
  if (e < len)
    load_unit<T, VEC>(u, vr + e, cr + e);
  else
    zero_unit<T, VEC>(u);
  wait();
  while (e < len) {
    const int en = e + step;
    Unit<T, VEC> un;
    if (en < len)
      load_unit<T, VEC>(un, vr + en, cr + en);
    else
      zero_unit<T, VEC>(un);
    T xv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      xv[i] = (e + i < len) ? xread(u.c[i]) : T(0);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = mad(acc, u.v[i], xv[i]);
    u = un;
    e = en;
  }
  // every lane of the warp reaches the shuffles (the loop above only
  // diverges inside the warp and reconverges here)
  for (int o = (1 << tpr_log2) >> 1; o > 0; o >>= 1)
    acc = acc + shfl_xor(acc, o);
  if (lane == 0 && row < Lrow) ys[row] = acc;
}

// y[s, trows[s, j]] += tvals[s, j] * g[s, tgidx[s, j]], rows Lrow dropped.
// Tpad % kTailPerThread == 0 and the tables' shard rows 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
ell_tail(const T* __restrict__ tvals, const int* __restrict__ trows,
         const int* __restrict__ tgidx, const T* __restrict__ g,
         T* __restrict__ y, int64_t Lrow, int64_t Tpad, int64_t gcols,
         int64_t g_stride) {
  constexpr int E = kTailPerThread;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const T* gs = g + (int64_t)s * g_stride;
  T* ys = y + (int64_t)s * Lrow;
  const int64_t per_block = (int64_t)blockDim.x * E;
  // the loop bound is the same for the whole block, so every warp reaches
  // its shuffles whole
  for (int64_t b0 = (int64_t)blockIdx.x * per_block; b0 < Tpad;
       b0 += (int64_t)gridDim.x * per_block) {
    const int64_t j0 = b0 + (int64_t)threadIdx.x * E;
    int r[E], c[E];
    T v[E];
    if (j0 < Tpad) {
      const int64_t k0 = (int64_t)s * Tpad + j0;
      const int4* rp = reinterpret_cast<const int4*>(trows + k0);
      const int4* cp = reinterpret_cast<const int4*>(tgidx + k0);
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const int4 a = __ldg(rp + q), b = __ldg(cp + q);
        r[4 * q] = a.x; r[4 * q + 1] = a.y; r[4 * q + 2] = a.z; r[4 * q + 3] = a.w;
        c[4 * q] = b.x; c[4 * q + 1] = b.y; c[4 * q + 2] = b.z; c[4 * q + 3] = b.w;
      }
      constexpr int V = kVec<T>;
      static_assert(E % V == 0, "a thread's tail values are whole units");
#pragma unroll
      for (int q = 0; q < E / V; ++q) {
        T a[V];
        ldg16(tvals + k0 + q * V, a);
#pragma unroll
        for (int i = 0; i < V; ++i) v[q * V + i] = a[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        r[i] = (int)Lrow;
        c[i] = 0;
        v[i] = T(0);
      }
    }
    T p[E];
#pragma unroll
    for (int i = 0; i < E; ++i)
      p[i] = (r[i] < Lrow && c[i] < gcols) ? mul(v[i], ldg1(gs + c[i]))
                                              : T(0);
    // runs inside the thread: all but the last are added here
    int key = r[0];
    T val = p[0];
#pragma unroll
    for (int i = 1; i < E; ++i) {
      if (r[i] != key) {
        if (key < Lrow) atomic_add(ys + key, val);
        key = r[i];
        val = p[i];
      } else {
        val = val + p[i];
      }
    }
    // segmented inclusive scan of the last runs over the warp's lanes
    const int kup = __shfl_up_sync(kFull, key, 1);
    const int head = (lane == 0 || kup != key) ? 1 : 0;
    int hf = head;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T vup = shfl_up(val, o);
      const int hup = __shfl_up_sync(kFull, hf, o);
      if (lane >= o) {
        if (!hf) val = val + vup;
        hf |= hup;
      }
    }
    const int next_head = __shfl_down_sync(kFull, head, 1);
    if ((lane == 31 || next_head) && key < Lrow) atomic_add(ys + key, val);
  }
}

template <typename T>
static void launch_tail(const void* tvals, const void* trows,
                        const void* tgidx, const void* g, void* y, int64_t S,
                        int64_t Lrow, int64_t Tpad, int64_t gcols,
                        int64_t g_stride, cudaStream_t st) {
  const int64_t per_block = (int64_t)kTailThreads * kTailPerThread;
  int64_t blocks = (Tpad + per_block - 1) / per_block;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  dim3 grid((unsigned)blocks, (unsigned)S);
  ell_tail<T><<<grid, kTailThreads, 0, st>>>(
      (const T*)tvals, (const int*)trows, (const int*)tgidx, (const T*)g,
      (T*)y, Lrow, Tpad, gcols, g_stride);
}

static inline int log2_pow2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}
