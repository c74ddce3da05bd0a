// One level's step of one sweep of the device solver's wave solve
// (hpclinalg_torch/solver/device_mf.py DeviceMF._solve_impl) in one launch,
// on one right-hand-side buffer y (S shards, rows, k columns) updated in
// place. A level holds S x B fronts; front f of shard s has nc live columns
// ccol[f, :nc] and nr live update rows crow[f, :nr] (slots of y[s]), and
// its factor's blocks A (NC x NC), M and, for the LDL^T, d:
//
//   front_fwd:  w = A y[ccol]               A lower-triangular (L11^-1, or
//               y[ccol] = w / d  (or w)       U11^-T for LU's transposed
//               y[crow] -= M w                solve); M = L21, or U12^T
//   front_bwd:  y[ccol] = A (y[ccol] - M y[crow])
//                                           A upper-triangular (L11^-T, or
//                                             U11^-1); M = L21^T, or U12
//
// The rows y[crow] are columns of the fronts' ancestors, which lie in
// higher levels: the forward step adds into them before any step reads
// them, the backward step reads them after their own step has solved
// them. So one buffer carries the right-hand side, z and x.
//
// Replaces no TPU kernel: the JAX engine's solve is left to XLA, which
// fuses each level's gathers, products and scatters. The port's plain step
// ran each level as about 18 PyTorch operations over padded tensors: two
// gathers, the scatter of z, the update's scatter-add and four full-size
// buffers zeroed a solve.
//
// Bound: bytes, at every level at narrow widths (k = 1: a factor entry
// is used once, and the live factor and the rows it touches are the least
// the step can move); at k = 64 bytes plus the FMA work of the small fronts
// (the wide fronts' products, above 20 flop a byte, stay with
// cuBLAS: ops/cuda_front_solve.py front_route). Design:
//   * Padding is never touched: a front's live columns and update rows are
//     prefixes of its padded ones (device_mf._schedule checks it and keeps
//     their counts), so a block reads and writes only the live rows of y
//     and the live entries of A and M, and of A only its triangle. The
//     identity and zero entries of the padding only ever add zeros.
//   * Whole mode, where a level has fronts enough to fill the card: a block
//     of 128 threads a front and a tile of KT right-hand-side columns (KT =
//     1, 8 or 32 by k; the column tile fastest in the grid, so a front's
//     tiles read its factor close together, through L2), walking the front
//     in tiles of 32 rows, in place: the forward step takes its row tiles
//     from the last to the first, so that z written into a tile's rows is
//     never read again (a lower-triangular row reads only the rows before
//     it); the backward step first writes r = z - M y[crow] over z, then
//     takes its row tiles from the first (an upper-triangular row reads
//     only the rows after it).
//   * Two-phase mode, where a level has too few fronts (the top levels at
//     k = 1: one front of 1,894 columns) or too many row tiles a front (a
//     block walks them in series): a block a row tile and span of 256
//     columns of a product, so that a front's work spreads over the
//     card. The first phase sums its share of w (forward) or of r =
//     z - M y[crow] (backward) into a scratch buffer by atomic adds, then
//     counts itself done on the front's counter; the second phase's blocks
//     wait for the count and then take the update rows and z (forward) or
//     x (backward, added into y[ccol], which the first phase zeroed after
//     reading z). Blocks take their places in the grid from a ticket, so a
//     waiting block waits only on blocks that are already running.
//   * The products: at KT = 1 (a factor entry used once) the operand's rows
//     are staged in shared memory 256 at a time and A or M is read straight
//     from memory along its unit stride, many loads in flight a thread
//     (consecutive rows in the lanes where rows are contiguous, as in the
//     column-major inverses torch's triangular solves return; a row's
//     entries in the lanes otherwise, summed by shuffles); at KT = 8 and 32
//     tiles of A or M and of the operand rows are staged in shared memory
//     and a thread holds 2 or 8 rows of one column.
//   * A warp a front at k = 1 where fronts have at most 32 columns (the
//     widest levels, 27,647 fronts of 3.7 live columns on average): lane i
//     holds row i, the operand's entries come from the other lanes by
//     shuffles, and no barrier is crossed.
//   * The forward update rows are atomic adds in every mode: sibling fronts
//     share ancestors.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "values.cuh"

#define FS_THREADS 128
#define FS_TILE 32
#define FS_SPAN 256

// ---- what the steps need of each type ---------------------------------------
__device__ __forceinline__ float neg(float v) { return -v; }
__device__ __forceinline__ double neg(double v) { return -v; }
__device__ __forceinline__ c64 neg(c64 v) { return c64(-v.re, -v.im); }
__device__ __forceinline__ c128 neg(c128 v) { return c128(-v.re, -v.im); }

template <typename T>
__device__ __forceinline__ T sub(T a, T b) { return a + neg(b); }
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }

// a / b; a complex b is scaled by 2^-e first, e the exponent of
// max(|Re b|, |Im b|) (exact, from the bits), so |b|^2 neither overflows nor
// underflows
__device__ __forceinline__ float div_(float a, float b) { return a / b; }
__device__ __forceinline__ double div_(double a, double b) { return a / b; }
__device__ __forceinline__ c64 div_(c64 a, c64 b) {
  const int bits = __float_as_int(fmaxf(fabsf(b.re), fabsf(b.im))) &
                   0x7f800000;
  const float sc = __int_as_float(0x7f000000 - bits);
  const float c = b.re * sc, d = b.im * sc, s = sc / (c * c + d * d);
  return mul(a, c64(c * s, -d * s));
}
__device__ __forceinline__ c128 div_(c128 a, c128 b) {
  const long long bits =
      __double_as_longlong(fmax(fabs(b.re), fabs(b.im))) &
      0x7ff0000000000000LL;
  const double sc = __longlong_as_double(0x7fe0000000000000LL - bits);
  const double c = b.re * sc, d = b.im * sc, s = sc / (c * c + d * d);
  return mul(a, c128(c * s, -d * s));
}

// a load through L2 only: another block's writes, after its fence
__device__ __forceinline__ float ldcg1(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ldcg1(const double* p) { return __ldcg(p); }
__device__ __forceinline__ c64 ldcg1(const c64* p) {
  const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
  return c64(q.x, q.y);
}
__device__ __forceinline__ c128 ldcg1(const c128* p) {
  const double2 q = __ldcg(reinterpret_cast<const double2*>(p));
  return c128(q.x, q.y);
}

// ---- a launch's operands ----------------------------------------------------
template <typename T>
struct FrontArgs {
  T* y;                        // (S, rows, k), columns contiguous
  int64_t ys, yr;              // y's shard and row strides
  const int64_t* ccol;         // (S * B, NC) slots of y[s]
  const int64_t* crow;         // (S * B, NR)
  const int* ncol;             // (S * B) live columns, a prefix
  const int* nrow;             // (S * B) live update rows, a prefix
  const T* A;                  // (S, B, NC, NC) through as, ab, ar, ac
  const T* M;                  // (S, B, NR, NC) forward, (S, B, NC, NR) backward
  const T* d;                  // (S, B, NC) the LDL^T's pivots, or null
  T* scratch;                  // two-phase: (S * B, NC, k) zeros; else null
  unsigned* count;             // two-phase: S * B * nq counters and a ticket
  int64_t as, ab, ar, ac, ms, mb, mr, mc, ds, db, di;
  int F, B, NC, NR, k, nq;     // F = S * B fronts
  int mode;                    // 0 whole, 1 two-phase, 2 a warp a front
};

// row j of an operand of a product, its columns from co: base[(idx ? idx[j]
// : j - off) * rs + co + c], read through L2 where another block wrote it
template <typename T>
struct RowSrc {
  const T* base;
  const int64_t* idx;
  int64_t rs;
  int co, off;
  bool l2;
  __device__ T at(int j, int c) const {
    const int64_t r = idx ? idx[j] : (int64_t)(j - off);
    const T* p = base + r * rs + co + c;
    return l2 ? ldcg1(p) : *p;
  }
};

// the threads of a block over a tile's FS_TILE rows and KT columns
template <int KT>
struct Lay {
  static constexpr int RG = FS_THREADS / KT;  // row groups
  static constexpr int RPT = RG >= FS_TILE ? 1 : FS_TILE / RG;  // rows a thread
  static constexpr int JS = RG >= FS_TILE ? RG / FS_TILE : 1;   // shares a sum
  // KT = 1: the staged operand rows, the shares of the sums and w; else a
  // tile of A or M and a tile of operand rows
  static constexpr int SMEM = KT == 1 ? FS_SPAN + JS * FS_TILE + FS_TILE
                                      : FS_TILE * (FS_TILE + 1) + FS_TILE * KT;
};

template <typename T, int KT>
struct Team {
  using L = Lay<KT>;
  T* sA;    // KT > 1: [FS_TILE][FS_TILE + 1], a tile of A or M
  T* sB;    // KT > 1: [FS_TILE][KT], operand rows, or w, or r
  T* sV;    // KT = 1: [FS_SPAN] operand rows
  T* sRed;  // KT = 1: [JS][FS_TILE] the shares of the sums
  T* sW;    // KT = 1: [FS_TILE] w
  int c, rg, js, row0;

  __device__ Team(T* smem) {
    if (KT == 1) {
      sA = sB = nullptr;
      sV = smem;
      sRed = sV + FS_SPAN;
      sW = sRed + L::JS * FS_TILE;
    } else {
      sA = smem;
      sB = sA + FS_TILE * (FS_TILE + 1);
      sV = sRed = sW = nullptr;
    }
    c = threadIdx.x % KT;
    rg = threadIdx.x / KT;
    row0 = L::JS > 1 ? rg % FS_TILE : rg;
    js = L::JS > 1 ? rg / FS_TILE : 0;
  }
  // the owners hold the tile's sums: row row(p), column c
  __device__ int row(int p) const { return row0 + L::RG * p; }
  __device__ bool owner() const { return js == 0; }

  __device__ void zero(T (&acc)[L::RPT]) const {
#pragma unroll
    for (int p = 0; p < L::RPT; ++p) acc[p] = T(0);
  }

  // acc[p] += sum over jj < jlen of sA[row(p)][jj] sB[jj][c]; rows past
  // ilen are skipped (the same rows in a whole warp)
  __device__ void mac(T (&acc)[L::RPT], int jlen, int ilen) const {
    for (int jj = 0; jj < jlen; ++jj) {
      const T b = sB[jj * KT + c];
#pragma unroll
      for (int p = 0; p < L::RPT; ++p)
        if (row(p) < ilen)
          acc[p] = mad(acc[p], sA[row(p) * (FS_TILE + 1) + jj], b);
    }
  }
};

// sA[ii][jj] = X[i0 + ii][j0 + jj] for ii < ilen, jj < jlen inside the
// triangle (tri > 0: j <= i, tri < 0: j >= i, 0: all), else 0; the threads
// walk X along its unit stride
template <typename T>
__device__ void load_tile(T* sA, const T* X, int64_t sr, int64_t sc, int i0,
                          int ilen, int j0, int jlen, int tri) {
  const bool jfast = sc == 1;
  for (int e = threadIdx.x; e < FS_TILE * FS_TILE; e += FS_THREADS) {
    const int ii = jfast ? e / FS_TILE : e % FS_TILE;
    const int jj = jfast ? e % FS_TILE : e / FS_TILE;
    const int i = i0 + ii, j = j0 + jj;
    T v = T(0);
    if (ii < ilen && jj < jlen && (tri == 0 || (tri > 0 ? j <= i : j >= i)))
      v = ldg1(X + i * sr + j * sc);
    sA[ii * (FS_TILE + 1) + jj] = v;
  }
}

__device__ __forceinline__ bool in_tri(int tri, int i, int j) {
  return tri == 0 || (tri > 0 ? j <= i : j >= i);
}

// The product of a tile: the owners' acc = X[i0 : i0 + ilen, ja : ja + jlen]
// (inside the triangle tri) times the operand rows ja .. ja + jlen of v, its
// columns c < kc. KT = 1: the operand rows staged FS_SPAN at a time, X read
// straight from memory along its unit stride with many loads in flight
// (consecutive rows in the lanes where its rows are contiguous, each row's
// entries in the lanes otherwise); KT > 1: tiles of X and of the operand
// staged in shared memory.
template <typename T, int KT>
__device__ void part(const Team<T, KT>& tm, T (&acc)[Lay<KT>::RPT],
                     const T* X, int64_t sr, int64_t sc, int i0, int ilen,
                     int ja, int jlen, int tri, const RowSrc<T>& v, int kc) {
  tm.zero(acc);
  if constexpr (KT == 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int W = FS_THREADS / 32;
    const bool rows_fast = sr == 1 && sc != 1;
    T cacc = T(0);
    T racc[FS_TILE / W];
#pragma unroll
    for (int p = 0; p < FS_TILE / W; ++p) racc[p] = T(0);
    for (int w0 = 0; w0 < jlen; w0 += FS_SPAN) {
      const int wl = min(FS_SPAN, jlen - w0), jb = ja + w0;
      __syncthreads();
      for (int e = threadIdx.x; e < wl; e += FS_THREADS)
        tm.sV[e] = v.at(jb + e, 0);
      __syncthreads();
      if (rows_fast) {
        const int i = i0 + lane;
        if (lane < ilen) {
          const T* xr = X + (int64_t)i * sr;
#pragma unroll 8
          for (int jj = warp; jj < wl; jj += W)
            if (in_tri(tri, i, jb + jj))
              cacc = mad(cacc, ldg1(xr + (int64_t)(jb + jj) * sc), tm.sV[jj]);
        }
      } else {
#pragma unroll
        for (int p = 0; p < FS_TILE / W; ++p) {
          const int i = i0 + warp + W * p;
          if (warp + W * p < ilen) {
            const T* xr = X + (int64_t)i * sr;
            T s = T(0);
#pragma unroll 4
            for (int jj = lane; jj < wl; jj += 32)
              if (in_tri(tri, i, jb + jj))
                s = mad(s, ldg1(xr + (int64_t)(jb + jj) * sc), tm.sV[jj]);
            racc[p] = racc[p] + s;
          }
        }
      }
    }
    __syncthreads();
    if (rows_fast) {
      tm.sRed[warp * FS_TILE + lane] = cacc;
      __syncthreads();
      if (warp == 0) {
        T s = tm.sRed[lane];
#pragma unroll
        for (int q = 1; q < W; ++q) s = s + tm.sRed[q * FS_TILE + lane];
        acc[0] = s;
      }
    } else {
#pragma unroll
      for (int p = 0; p < FS_TILE / W; ++p) {
        T s = racc[p];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s = s + shfl_xor(s, o);
        if (lane == 0) tm.sRed[warp + W * p] = s;
      }
      __syncthreads();
      if (warp == 0) acc[0] = tm.sRed[lane];
    }
    __syncthreads();
  } else {
    for (int j0 = 0; j0 < jlen; j0 += FS_TILE) {
      const int jl = min(FS_TILE, jlen - j0);
      __syncthreads();
      load_tile(tm.sA, X, sr, sc, i0, ilen, ja + j0, jl, tri);
      for (int e = threadIdx.x; e < FS_TILE * KT; e += FS_THREADS) {
        const int jj = e / KT, c = e % KT;
        tm.sB[e] = jj < jl && c < kc ? v.at(ja + j0 + jj, c) : T(0);
      }
      __syncthreads();
      tm.mac(acc, jl, ilen);
    }
  }
}

// y[crow[r]] -= M[r, i0 : i0 + ilen] w for the live update rows, w the
// owners' acc (rows i0 .. i0 + ilen of the front)
template <typename T, int KT>
__device__ void update(const Team<T, KT>& tm, const FrontArgs<T>& a,
                       const T* M, T* ys, const int64_t* cr, int nr, int i0,
                       int ilen, int c0, int kc, const T (&w)[Lay<KT>::RPT]) {
  using L = Lay<KT>;
  if (nr == 0) return;
  T* sw = KT == 1 ? tm.sW : tm.sB;
  __syncthreads();
  if (tm.owner()) {
#pragma unroll
    for (int p = 0; p < L::RPT; ++p) {
      const int i = tm.row(p);
      sw[i * KT + tm.c] = i < ilen && tm.c < kc ? w[p] : T(0);
    }
  }
  for (int r0 = 0; r0 < nr; r0 += FS_TILE) {
    const int rlen = min(FS_TILE, nr - r0);
    T u[L::RPT];
    if constexpr (KT == 1) {
      const RowSrc<T> src{tm.sW, nullptr, 1, 0, i0, false};
      part<T, KT>(tm, u, M, a.mr, a.mc, r0, rlen, i0, ilen, 0, src, kc);
    } else {
      __syncthreads();
      load_tile(tm.sA, M, a.mr, a.mc, r0, rlen, i0, ilen, 0);
      __syncthreads();
      tm.zero(u);
      tm.mac(u, ilen, rlen);
    }
    if (tm.owner()) {
#pragma unroll
      for (int p = 0; p < L::RPT; ++p) {
        const int r = tm.row(p);
        if (r < rlen && tm.c < kc)
          atomic_add(ys + cr[r0 + r] * a.yr + c0 + tm.c, neg(u[p]));
      }
    }
  }
}

// ---- the two-phase mode's order -----------------------------------------------
// A block takes the next ticket: the first tickets are the first phase's
// items, so a second-phase item waits only on items that are already running
__device__ __forceinline__ unsigned take_ticket(unsigned* t, unsigned* s) {
  __syncthreads();
  if (threadIdx.x == 0) *s = atomicAdd(t, 1u);
  __syncthreads();
  return *s;
}
__device__ __forceinline__ void arrive(unsigned* c) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(c, 1u);
}
__device__ __forceinline__ void wait_for(unsigned* c, unsigned n) {
  if (threadIdx.x == 0)
    while (atomicAdd(c, 0u) < n) __nanosleep(64);
  __syncthreads();
  __threadfence();
}

struct Front {
  int f, q, nc, nr, c0, kc;
  int64_t s, b;
};

template <typename T>
__device__ Front front_of(const FrontArgs<T>& a, int f, int q, int KT) {
  Front fr;
  fr.f = f;
  fr.q = q;
  fr.nc = a.ncol[f];
  fr.nr = a.nrow[f];
  fr.c0 = q * KT;
  fr.kc = min(KT, a.k - fr.c0);
  fr.s = f / a.B;
  fr.b = f % a.B;
  return fr;
}

// ---- a warp a front (k = 1, NC <= 32) ------------------------------------------
__device__ __forceinline__ float shfl_idx(float v, int l) {
  return __shfl_sync(kFull, v, l);
}
__device__ __forceinline__ double shfl_idx(double v, int l) {
  return __shfl_sync(kFull, v, l);
}
__device__ __forceinline__ c64 shfl_idx(c64 v, int l) {
  return c64(__shfl_sync(kFull, v.re, l), __shfl_sync(kFull, v.im, l));
}
__device__ __forceinline__ c128 shfl_idx(c128 v, int l) {
  return c128(__shfl_sync(kFull, v.re, l), __shfl_sync(kFull, v.im, l));
}

// The fronts of the widest levels hold a few live columns and rows each:
// lane i holds row i of the front, the operand's entries come from the
// other lanes by shuffles, A and M are read along their columns (coalesced
// where their rows are contiguous), and no barrier is crossed.
template <typename T>
__device__ void rows_fwd(const FrontArgs<T>& a, int f) {
  const int lane = threadIdx.x & 31;
  const int nc = a.ncol[f], nr = a.nrow[f];
  const int64_t s = f / a.B, b = f % a.B;
  T* ys = a.y + s * a.ys;
  const int64_t* cc = a.ccol + (int64_t)f * a.NC;
  const int64_t* cr = a.crow + (int64_t)f * a.NR;
  const T* A = a.A + s * a.as + b * a.ab + lane * a.ar;
  const T* M = a.M + s * a.ms + b * a.mb;
  const T seg = lane < nc ? ys[cc[lane] * a.yr] : T(0);
  T w = T(0);
#pragma unroll 8
  for (int j = 0; j < nc; ++j) {
    const T sj = shfl_idx(seg, j);
    if (lane >= j && lane < nc) w = mad(w, ldg1(A + j * a.ac), sj);
  }
  if (lane < nc)
    ys[cc[lane] * a.yr] =
        a.d ? div_(w, a.d[s * a.ds + b * a.db + lane * a.di]) : w;
  for (int r0 = 0; r0 < nr; r0 += 32) {
    const int r = r0 + lane;
    const T* Mr = M + (int64_t)r * a.mr;
    T u = T(0);
#pragma unroll 8
    for (int i = 0; i < nc; ++i) {
      const T wi = shfl_idx(w, i);
      if (r < nr) u = mad(u, ldg1(Mr + i * a.mc), wi);
    }
    if (r < nr) atomic_add(ys + cr[r] * a.yr, neg(u));
  }
}

template <typename T>
__device__ void rows_bwd(const FrontArgs<T>& a, int f) {
  const int lane = threadIdx.x & 31;
  const int nc = a.ncol[f], nr = a.nrow[f];
  const int64_t s = f / a.B, b = f % a.B;
  T* ys = a.y + s * a.ys;
  const int64_t* cc = a.ccol + (int64_t)f * a.NC;
  const int64_t* cr = a.crow + (int64_t)f * a.NR;
  const T* A = a.A + s * a.as + b * a.ab + lane * a.ar;
  const T* M = a.M + s * a.ms + b * a.mb + lane * a.mr;
  T acc = T(0);
  for (int p0 = 0; p0 < nr; p0 += 32) {
    const int pl = min(32, nr - p0);
    const T xr = lane < pl ? ys[cr[p0 + lane] * a.yr] : T(0);
#pragma unroll 8
    for (int p = 0; p < pl; ++p) {
      const T xp = shfl_idx(xr, p);
      if (lane < nc) acc = mad(acc, ldg1(M + (p0 + p) * a.mc), xp);
    }
  }
  const T r = lane < nc ? sub(ys[cc[lane] * a.yr], acc) : T(0);
  T x = T(0);
#pragma unroll 8
  for (int j = 0; j < nc; ++j) {
    const T rj = shfl_idx(r, j);
    if (lane <= j) x = mad(x, ldg1(A + j * a.ac), rj);
  }
  if (lane < nc) ys[cc[lane] * a.yr] = x;
}


// ---- the forward step -------------------------------------------------------
template <typename T, int KT>
__device__ void fwd_blocks(const FrontArgs<T>& a) {
  using L = Lay<KT>;
  __shared__ __align__(16) unsigned char raw[L::SMEM * sizeof(T)];
  __shared__ unsigned ticket;
  const Team<T, KT> tm(reinterpret_cast<T*>(raw));
  const int T1 = (a.NC + FS_TILE - 1) / FS_TILE;    // row tiles of w
  const int J1 = (a.NC + FS_SPAN - 1) / FS_SPAN;    // spans of A's columns
  const int TR = (a.NR + FS_TILE - 1) / FS_TILE;    // row tiles of M
  unsigned id = blockIdx.x;
  if (a.mode == 1) id = take_ticket(a.count + (int64_t)a.F * a.nq, &ticket);
  const int64_t n1 = a.mode == 1 ? (int64_t)T1 * J1 : 1;
  const int64_t per = a.mode == 1 ? T1 * J1 + (TR + T1) * J1 : 1;
  const int64_t nfq = (int64_t)a.F * a.nq;
  int64_t item, fq;
  bool first;
  if (a.mode != 1) {
    fq = id;
    item = 0;
    first = true;
  } else if ((int64_t)id < nfq * n1) {
    fq = id / n1;
    item = id % n1;
    first = true;
  } else {
    const int64_t id2 = id - nfq * n1, n2 = per - n1;
    fq = id2 / n2;
    item = id2 % n2;
    first = false;
  }
  const Front fr = front_of(a, (int)(fq / a.nq), (int)(fq % a.nq), KT);
  T* ys = a.y + fr.s * a.ys;
  const int64_t* cc = a.ccol + (int64_t)fr.f * a.NC;
  const int64_t* cr = a.crow + (int64_t)fr.f * a.NR;
  const T* A = a.A + fr.s * a.as + fr.b * a.ab;
  const T* M = a.M + fr.s * a.ms + fr.b * a.mb;
  const T* d = a.d ? a.d + fr.s * a.ds + fr.b * a.db : nullptr;
  const RowSrc<T> yrows{ys, cc, a.yr, fr.c0, 0, false};
  T acc[L::RPT];

  if (a.mode != 1) {
    // whole mode: the front's row tiles from the last to the first, z in
    // place (a row tile reads only the rows before its end)
    const int tiles = (fr.nc + FS_TILE - 1) / FS_TILE;
    for (int t = tiles - 1; t >= 0; --t) {
      const int i0 = t * FS_TILE, ilen = min(FS_TILE, fr.nc - i0);
      part<T, KT>(tm, acc, A, a.ar, a.ac, i0, ilen, 0, i0 + ilen, 1, yrows,
                  fr.kc);
      if (tm.owner()) {
#pragma unroll
        for (int p = 0; p < L::RPT; ++p) {
          const int i = tm.row(p);
          if (i < ilen && tm.c < fr.kc)
            ys[cc[i0 + i] * a.yr + fr.c0 + tm.c] =
                d ? div_(acc[p], d[(int64_t)(i0 + i) * a.di]) : acc[p];
        }
      }
      update<T, KT>(tm, a, M, ys, cr, fr.nr, i0, ilen, fr.c0, fr.kc, acc);
    }
    return;
  }

  T* W = a.scratch + (int64_t)fr.f * a.NC * a.k;
  unsigned* cnt = a.count + fq;
  if (first) {
    // w[t] += A[t rows, span jc] y[ccol[span jc]]
    const int t = (int)(item / J1), jc = (int)(item % J1);
    const int i0 = t * FS_TILE, ilen = min(FS_TILE, fr.nc - i0);
    const int ja = jc * FS_SPAN, jlen = min(FS_SPAN, min(fr.nc, i0 + ilen) - ja);
    if (ilen > 0 && jlen > 0) {
      part<T, KT>(tm, acc, A, a.ar, a.ac, i0, ilen, ja, jlen, 1, yrows, fr.kc);
      if (tm.owner()) {
#pragma unroll
        for (int p = 0; p < L::RPT; ++p) {
          const int i = tm.row(p);
          if (i < ilen && tm.c < fr.kc)
            atomic_add(W + (int64_t)(i0 + i) * a.k + fr.c0 + tm.c, acc[p]);
        }
      }
    }
    arrive(cnt);
    return;
  }
  const int v = (int)(item / J1), jc = (int)(item % J1);
  if (v < TR) {
    // y[crow[v rows]] -= M[v rows, span jc] w[span jc]
    const int r0 = v * FS_TILE, rlen = min(FS_TILE, fr.nr - r0);
    const int ja = jc * FS_SPAN, jlen = min(FS_SPAN, fr.nc - ja);
    if (rlen <= 0 || jlen <= 0) return;
    wait_for(cnt, (unsigned)(T1 * J1));
    const RowSrc<T> wrows{W, nullptr, a.k, fr.c0, 0, true};
    part<T, KT>(tm, acc, M, a.mr, a.mc, r0, rlen, ja, jlen, 0, wrows, fr.kc);
    if (tm.owner()) {
#pragma unroll
      for (int p = 0; p < L::RPT; ++p) {
        const int r = tm.row(p);
        if (r < rlen && tm.c < fr.kc)
          atomic_add(ys + cr[r0 + r] * a.yr + fr.c0 + tm.c, neg(acc[p]));
      }
    }
    return;
  }
  // y[ccol[t rows]] = w[t rows] / d
  const int i0 = (v - TR) * FS_TILE, ilen = min(FS_TILE, fr.nc - i0);
  if (jc != 0 || ilen <= 0) return;
  wait_for(cnt, (unsigned)(T1 * J1));
  for (int e = threadIdx.x; e < ilen * KT; e += FS_THREADS) {
    const int i = e / KT, c = e % KT;
    if (c < fr.kc) {
      const T w = ldcg1(W + (int64_t)(i0 + i) * a.k + fr.c0 + c);
      ys[cc[i0 + i] * a.yr + fr.c0 + c] =
          d ? div_(w, d[(int64_t)(i0 + i) * a.di]) : w;
    }
  }
}

// ---- the backward step ------------------------------------------------------
template <typename T, int KT>
__device__ void bwd_blocks(const FrontArgs<T>& a) {
  using L = Lay<KT>;
  __shared__ __align__(16) unsigned char raw[L::SMEM * sizeof(T)];
  __shared__ unsigned ticket;
  const Team<T, KT> tm(reinterpret_cast<T*>(raw));
  const int T1 = (a.NC + FS_TILE - 1) / FS_TILE;     // row tiles
  const int J1 = (a.NC + FS_SPAN - 1) / FS_SPAN;     // spans of A's columns
  const int P1 = max(1, (a.NR + FS_SPAN - 1) / FS_SPAN);  // spans of M's
  unsigned id = blockIdx.x;
  if (a.mode == 1) id = take_ticket(a.count + (int64_t)a.F * a.nq, &ticket);
  const int64_t n1 = a.mode == 1 ? (int64_t)T1 * P1 : 1;
  const int64_t per = a.mode == 1 ? n1 + (int64_t)T1 * J1 : 1;
  const int64_t nfq = (int64_t)a.F * a.nq;
  int64_t item, fq;
  bool first;
  if (a.mode != 1) {
    fq = id;
    item = 0;
    first = true;
  } else if ((int64_t)id < nfq * n1) {
    fq = id / n1;
    item = id % n1;
    first = true;
  } else {
    const int64_t id2 = id - nfq * n1, n2 = per - n1;
    fq = id2 / n2;
    item = id2 % n2;
    first = false;
  }
  const Front fr = front_of(a, (int)(fq / a.nq), (int)(fq % a.nq), KT);
  T* ys = a.y + fr.s * a.ys;
  const int64_t* cc = a.ccol + (int64_t)fr.f * a.NC;
  const int64_t* cr = a.crow + (int64_t)fr.f * a.NR;
  const T* A = a.A + fr.s * a.as + fr.b * a.ab;
  const T* M = a.M + fr.s * a.ms + fr.b * a.mb;
  const RowSrc<T> xrows{ys, cr, a.yr, fr.c0, 0, false};
  const RowSrc<T> zrows{ys, cc, a.yr, fr.c0, 0, false};
  T acc[L::RPT];

  if (a.mode != 1) {
    // whole mode: r = z - M y[crow] over z, then x from the first row tile
    // (a row tile reads only the rows from its start)
    const int tiles = (fr.nc + FS_TILE - 1) / FS_TILE;
    for (int u = 0; u < tiles; ++u) {
      const int j0 = u * FS_TILE, jlen = min(FS_TILE, fr.nc - j0);
      part<T, KT>(tm, acc, M, a.mr, a.mc, j0, jlen, 0, fr.nr, 0, xrows,
                  fr.kc);
      if (tm.owner()) {
#pragma unroll
        for (int p = 0; p < L::RPT; ++p) {
          const int j = tm.row(p);
          if (j < jlen && tm.c < fr.kc) {
            T* yp = ys + cc[j0 + j] * a.yr + fr.c0 + tm.c;
            *yp = sub(*yp, acc[p]);
          }
        }
      }
    }
    for (int t = 0; t < tiles; ++t) {
      const int i0 = t * FS_TILE, ilen = min(FS_TILE, fr.nc - i0);
      part<T, KT>(tm, acc, A, a.ar, a.ac, i0, ilen, i0, fr.nc - i0, -1, zrows,
                  fr.kc);
      if (tm.owner()) {
#pragma unroll
        for (int p = 0; p < L::RPT; ++p) {
          const int i = tm.row(p);
          if (i < ilen && tm.c < fr.kc)
            ys[cc[i0 + i] * a.yr + fr.c0 + tm.c] = acc[p];
        }
      }
    }
    return;
  }

  T* Rs = a.scratch + (int64_t)fr.f * a.NC * a.k;
  unsigned* cnt = a.count + fq;
  if (first) {
    // r[u] += (z[u] if pc == 0) - M[u rows, span pc] y[crow[span pc]];
    // the z rows are zeroed for the second phase's sums
    const int u = (int)(item / P1), pc = (int)(item % P1);
    const int j0 = u * FS_TILE, jlen = min(FS_TILE, fr.nc - j0);
    const int pa = pc * FS_SPAN, plen = min(FS_SPAN, fr.nr - pa);
    if (jlen > 0 && (plen > 0 || pc == 0)) {
      if (plen > 0)
        part<T, KT>(tm, acc, M, a.mr, a.mc, j0, jlen, pa, plen, 0, xrows,
                    fr.kc);
      else
        tm.zero(acc);
      if (tm.owner()) {
#pragma unroll
        for (int p = 0; p < L::RPT; ++p) {
          const int j = tm.row(p);
          if (j < jlen && tm.c < fr.kc) {
            T r = neg(acc[p]);
            if (pc == 0) {
              T* yp = ys + cc[j0 + j] * a.yr + fr.c0 + tm.c;
              r = r + *yp;
              *yp = T(0);
            }
            atomic_add(Rs + (int64_t)(j0 + j) * a.k + fr.c0 + tm.c, r);
          }
        }
      }
    }
    arrive(cnt);
    return;
  }
  // y[ccol[t rows]] += A[t rows, span jc] r[span jc]
  const int t = (int)(item / J1), jc = (int)(item % J1);
  const int i0 = t * FS_TILE, ilen = min(FS_TILE, fr.nc - i0);
  const int ja = max(jc * FS_SPAN, i0);
  const int jlen = min(fr.nc, (jc + 1) * FS_SPAN) - ja;
  if (ilen <= 0 || jlen <= 0) return;
  wait_for(cnt, (unsigned)(T1 * P1));
  const RowSrc<T> rrows{Rs, nullptr, a.k, fr.c0, 0, true};
  part<T, KT>(tm, acc, A, a.ar, a.ac, i0, ilen, ja, jlen, -1, rrows, fr.kc);
  if (tm.owner()) {
#pragma unroll
    for (int p = 0; p < L::RPT; ++p) {
      const int i = tm.row(p);
      if (i < ilen && tm.c < fr.kc)
        atomic_add(ys + cc[i0 + i] * a.yr + fr.c0 + tm.c, acc[p]);
    }
  }
}

// ---- the kernels ------------------------------------------------------------
// WARP: a warp a front (KT = 1, lanes the rows); else blocks (KT = 1, 8 or
// 32).
template <typename T, int KT, bool WARP>
__global__ void __launch_bounds__(FS_THREADS) front_fwd(const FrontArgs<T> a) {
  if constexpr (WARP) {
    const int64_t w = (int64_t)blockIdx.x * (FS_THREADS / 32) +
                      (threadIdx.x >> 5);
    if (w < a.F) rows_fwd(a, (int)w);
  } else {
    fwd_blocks<T, KT>(a);
  }
}

template <typename T, int KT, bool WARP>
__global__ void __launch_bounds__(FS_THREADS) front_bwd(const FrontArgs<T> a) {
  if constexpr (WARP) {
    const int64_t w = (int64_t)blockIdx.x * (FS_THREADS / 32) +
                      (threadIdx.x >> 5);
    if (w < a.F) rows_bwd(a, (int)w);
  } else {
    bwd_blocks<T, KT>(a);
  }
}

// ---- launches -----------------------------------------------------------
template <typename T, int KT, bool WARP>
static int launch(int bwd, const FrontArgs<T>& a, int64_t fronts,
                  cudaStream_t stream) {
  const int64_t T1 = (a.NC + FS_TILE - 1) / FS_TILE;
  const int64_t J1 = (a.NC + FS_SPAN - 1) / FS_SPAN;
  int64_t per = 1;
  if (a.mode == 1 && bwd) {
    const int64_t P1 = std::max<int64_t>(1, (a.NR + FS_SPAN - 1) / FS_SPAN);
    per = T1 * P1 + T1 * J1;
  } else if (a.mode == 1) {
    per = T1 * J1 + ((a.NR + FS_TILE - 1) / FS_TILE + T1) * J1;
  }
  const int64_t warps = FS_THREADS / 32;
  const int64_t blocks = WARP ? (fronts + warps - 1) / warps
                              : fronts * a.nq * per;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (bwd)
    front_bwd<T, KT, WARP><<<(unsigned)blocks, FS_THREADS, 0, stream>>>(a);
  else
    front_fwd<T, KT, WARP><<<(unsigned)blocks, FS_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int run(int bwd, void* y, const void* ccol, const void* crow,
               const void* ncol, const void* nrow, const void* A,
               const void* M, const void* d, void* scratch, void* count,
               const int64_t* dims, const int64_t* st, void* stream) {
  // dims: S, B, NC, NR, k, KT, y's shard stride, y's row stride, mode
  FrontArgs<T> a;
  const int64_t S = dims[0], KT = dims[5];
  a.B = (int)dims[1];
  a.NC = (int)dims[2];
  a.NR = (int)dims[3];
  a.k = (int)dims[4];
  a.ys = dims[6];
  a.yr = dims[7];
  a.mode = (int)dims[8];
  if (S < 0 || a.B < 0 || a.NC < 0 || a.NR < 0 || a.k < 0 ||
      (KT != 1 && KT != 8 && KT != 32) || a.mode < 0 || a.mode > 2 ||
      (a.mode == 1) != (scratch != nullptr) ||
      (scratch == nullptr) != (count == nullptr) ||
      (a.mode == 2 && (KT != 1 || a.k != 1 || a.NC > FS_TILE)))
    return (int)cudaErrorInvalidValue;
  a.nq = (int)((a.k + KT - 1) / KT);
  a.F = (int)(S * a.B);
  if (S * a.B == 0 || a.k == 0 || a.NC == 0) return (int)cudaSuccess;
  a.y = (T*)y;
  a.ccol = (const int64_t*)ccol;
  a.crow = (const int64_t*)crow;
  a.ncol = (const int*)ncol;
  a.nrow = (const int*)nrow;
  a.A = (const T*)A;
  a.M = (const T*)M;
  a.d = (const T*)d;
  a.scratch = (T*)scratch;
  a.count = (unsigned*)count;
  a.as = st[0]; a.ab = st[1]; a.ar = st[2]; a.ac = st[3];
  a.ms = st[4]; a.mb = st[5]; a.mr = st[6]; a.mc = st[7];
  a.ds = st[8]; a.db = st[9]; a.di = st[10];
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.mode == 2) return launch<T, 1, true>(bwd, a, S * a.B, s);
  if (KT == 1) return launch<T, 1, false>(bwd, a, S * a.B, s);
  if (KT == 8) return launch<T, 8, false>(bwd, a, S * a.B, s);
  return launch<T, 32, false>(bwd, a, S * a.B, s);
}

extern "C" {

// One level's step (bwd 0: forward, 1: backward) on y in place. ccol, crow:
// int64 (S, B, NC) and (S, B, NR); ncol, nrow: int32 (S, B); A, M, d:
// through the strides st (entries: A's shard, front, row and column
// strides, then M's, then d's shard, front and entry strides; d null for
// no pivots); scratch and count: for the two-phase mode (mode 1: blocks of
// row tiles and column spans) zeros of (S B, NC, k) entries and of
// S B ceil(k / KT) + 1 counters (the last the blocks' ticket), else null
// (mode 0: a block a front and column tile; mode 2: a warp a front, k = 1
// and NC <= FS_TILE). dims: S, B, NC, NR, k, KT (1, 8 or 32), y's shard
// and row strides (its columns contiguous), mode. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for bad sizes).
#define FRONT_SOLVE_ENTRY(SUFFIX, T)                                          \
  int front_solve_##SUFFIX(int bwd, void* y, const void* ccol,                \
                           const void* crow, const void* ncol,                \
                           const void* nrow, const void* A, const void* M,    \
                           const void* d, void* scratch, void* count,         \
                           const int64_t* dims, const int64_t* st,            \
                           void* stream) {                                    \
    return run<T>(bwd, y, ccol, crow, ncol, nrow, A, M, d, scratch, count,    \
                  dims, st, stream);                                          \
  }

FRONT_SOLVE_ENTRY(f32, float)
FRONT_SOLVE_ENTRY(f64, double)
FRONT_SOLVE_ENTRY(c64, c64)
FRONT_SOLVE_ENTRY(c128, c128)

// The rows of a tile and the columns of a span (FS_TILE, FS_SPAN), which
// ops/cuda_front_solve.py checks against its TILE and SPAN when it loads
// the library.
int front_solve_tile(void) { return FS_TILE; }
int front_solve_span(void) { return FS_SPAN; }

}  // extern "C"
