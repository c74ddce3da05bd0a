// K5: the k-payload probe for Hopper — a column-payload gather.
//
//   out[t, j, l] = src[t, sel[t, l], j, idx[t, l]]
//
// src (ntiles, F, k, 128) f32, idx (ntiles, 1, 128) int8 in [0, 128), sel
// (ntiles, 1, 128) uint8 in [0, F), out (ntiles, k, 128) f32: for every lane
// l of a tile, the whole (k,) column idx[t, l] of source plane sel[t, l].
//
// Replaces the TPU kernel of tools/probe_kpayload.py (kern, via run): there
// each tile costs F masked passes, a lane gather of every source plane
// followed by a select, because the TPU's vector unit gathers only within
// a register. The card gathers natively, so this kernel reads only what
// the lanes select. It is a pure copy, so it agrees with its plain version
// bit for bit.
//
// Bound: device-memory reads of src in 32-byte sectors. A tile's row
// (t, f, j) is 512 bytes, 16 sectors of 8 floats. The tables are per tile,
// not per row, so a tile touches the same set of (plane, sector) pairs in
// all k rows: each pair with probability 1 - (1 - 1/(16 F))^128, about 63 %
// at F = 8. No kernel reads less than those sectors (the sector floor; the
// byte bound counts only the selected 4-byte values), and out is written
// once.
//
// Design: a block of 256 threads per tile, its k rows taken in chunks of
// KP_KC rows.
//  - The block builds, in shared memory, the sorted list of the tile's
//    touched (plane, sector) keys, plane * 16 + sector (address order
//    within a row), from the 128 (sel, idx) bytes: a 4096-bit map and a
//    popcount scan; and each lane's float in a staged row (its key's slot
//    in the list * 8 + idx % 8).
//  - Each chunk's touched sectors are fetched whole into a shared-memory
//    stage by cp.async, two 16-byte copies a sector and row, a thread per
//    copy, consecutive threads on consecutive sectors of one row; KP_STAGES
//    stages ring, so the next KP_STAGES - 1 chunks' copies are in flight
//    while the block writes this one.
//  - out[t, j, :] is written from the stage, coalesced along l.
// Each touched sector is one whole request, and two such blocks an SM keep
// about 80 KB in flight, where the first form issued one 4-byte load a
// thread, row and lane. Measured on the H100, both forms take about 92 %
// of the time of reading every plane whole, and as long again when every
// lane moves to the even sector of its pair (fewer sectors, the same
// 64-byte granules): the memory fetches 64-byte granules, 87 % of which a
// tile touches at F = 8 (PERF.md; tools/probe_kpayload.py's floors and
// granule control).

#include <cuda_runtime.h>
#include <stdint.h>

#define KP_LANES 128
#define KP_THREADS 256
#define KP_SECT 16                   // sectors in a 128-float row
#define KP_KC 8                      // rows of j a chunk
#define KP_STAGES 3                  // chunks in the ring
#define KP_KEYS 4096                 // keys plane * 16 + sector: sel < 256
#define KP_STAGE_FLOATS (KP_KC * KP_LANES * 8)   // a sector a lane at most

// One tile's touched sectors.
struct KpMeta {
  int n;                             // how many
  unsigned short key[KP_LANES];      // sorted keys, n of them
  unsigned short word[KP_LANES];     // lane l's float in a staged row
};

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

// The touched-sector list of tile t into m. Called by the whole block.
__device__ void build_meta(const int8_t* __restrict__ idx,
                           const uint8_t* __restrict__ sel, int64_t t,
                           KpMeta& m, unsigned* bm, int* pre, int* wsum) {
  const int tid = threadIdx.x;
  int key = 0, lo = 0, cnt = 0, incl = 0;
  if (tid < KP_LANES) {
    bm[tid] = 0u;
    // the wrapper checks idx in [0, 128); the mask keeps the map in bounds
    const int il = (int)(uint8_t)idx[t * KP_LANES + tid] & (KP_LANES - 1);
    key = (int)sel[t * KP_LANES + tid] * KP_SECT + (il >> 3);
    lo = il & 7;
  }
  __syncthreads();
  if (tid < KP_LANES) atomicOr(&bm[key >> 5], 1u << (key & 31));
  __syncthreads();
  if (tid < KP_LANES) {           // 128 map words, one a thread: scan counts
    cnt = __popc(bm[tid]);
    incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if ((tid & 31) >= o) incl += v;
    }
    if ((tid & 31) == 31) wsum[tid >> 5] = incl;
  }
  __syncthreads();
  if (tid < KP_LANES) {
    int excl = incl - cnt;
    for (int q = 0; q < (tid >> 5); ++q) excl += wsum[q];
    pre[tid] = excl;
    unsigned w = bm[tid];
    for (int p = excl; w; ++p, w &= w - 1)
      m.key[p] = (unsigned short)(tid * 32 + __ffs(w) - 1);
    if (tid == KP_LANES - 1) m.n = excl + cnt;
  }
  __syncthreads();
  if (tid < KP_LANES) {
    const unsigned below = bm[key >> 5] & ((1u << (key & 31)) - 1u);
    m.word[tid] = (unsigned short)((pre[key >> 5] + __popc(below)) * 8 + lo);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(KP_THREADS)
    kpayload(const float* __restrict__ src, const int8_t* __restrict__ idx,
             const uint8_t* __restrict__ sel, float* __restrict__ out, int F,
             int k) {
  extern __shared__ __align__(16) float stage[];   // KP_STAGES stages
  __shared__ KpMeta m;
  __shared__ unsigned bm[KP_KEYS / 32];
  __shared__ int pre[KP_KEYS / 32];
  __shared__ int wsum[KP_LANES / 32];
  const int tid = threadIdx.x;
  const int64_t t = blockIdx.x;
  const int nch = (k + KP_KC - 1) / KP_KC;
  build_meta(idx, sel, t, m, bm, pre, wsum);
  // this thread's copy: half a sector of the list, in every row
  const bool copies = tid < 2 * m.n;
  const int key = copies ? m.key[tid >> 1] : 0;
  const int half = (tid & 1) * 4;
  const float* s = src + (t * F + (key >> 4)) * (int64_t)k * KP_LANES +
                   (key & (KP_SECT - 1)) * 8 + half;
  float* d = stage + (tid >> 1) * 8 + half;

  // start the copies of chunk ch into stage ch % KP_STAGES
  auto issue = [&](int ch) {
    if (copies && ch < nch) {
      const int j0 = ch * KP_KC;
      const int rows = min(KP_KC, k - j0);
      float* dc = d + (ch % KP_STAGES) * KP_STAGE_FLOATS;
      for (int jj = 0; jj < rows; ++jj)
        cp_async16(dc + jj * KP_LANES * 8,
                   s + (int64_t)(j0 + jj) * KP_LANES);
    }
    cp_async_commit();      // one group a chunk, empty past the end
  };

  for (int ch = 0; ch < KP_STAGES - 1; ++ch) issue(ch);
  const int l = tid & (KP_LANES - 1);
  const int w = m.word[l];
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<KP_STAGES - 2>();      // chunk ch's group has landed
    __syncthreads();                     // ... for every thread's copies
    issue(ch + KP_STAGES - 1);           // into the stage chunk ch - 1 used
    const int j0 = ch * KP_KC;
    const int rows = min(KP_KC, k - j0);
    const float* st = stage + (ch % KP_STAGES) * KP_STAGE_FLOATS + w;
    float* o = out + (t * k + j0) * KP_LANES + l;
    for (int jj = tid / KP_LANES; jj < rows; jj += KP_THREADS / KP_LANES)
      o[(int64_t)jj * KP_LANES] = st[jj * KP_LANES * 8];
  }
  cp_async_wait<0>();
}

// kpayload's shared-memory opt-in, set once per device.
static cudaError_t kp_opt_in(size_t smem) {
  static int c_dev = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev == c_dev) return e;
  e = cudaFuncSetAttribute(kpayload,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) c_dev = dev;
  return e;
}

extern "C" {

// Returns cudaGetLastError() after the launch.
int kpayload_f32(const void* src, const void* idx, const void* sel, void* out,
                 int64_t ntiles, int F, int k, void* stream) {
  if (ntiles < 1 || ntiles > 2147483647 || F < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)KP_STAGES * KP_STAGE_FLOATS * sizeof(float);
  const cudaError_t e = kp_opt_in(smem);
  if (e != cudaSuccess) return (int)e;
  kpayload<<<(unsigned)ntiles, KP_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)src, (const int8_t*)idx, (const uint8_t*)sel,
      (float*)out, F, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
