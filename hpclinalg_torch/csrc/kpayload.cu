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
// a register. The card gathers natively, so this kernel reads only the
// selected plane: a block per tile, a thread per (j, l), lanes l along
// threadIdx.x. Writes are coalesced along l; reads go through L1 (__ldg).
// It is a pure copy, so it agrees with its plain version bit for bit.
//
// Bound: device-memory reads of src in 32-byte sectors. A tile's row
// (t, f, j) is 512 bytes, 16 sectors; each of the 128 random picks lands in
// a given sector of a given plane with probability 1/(16 F), so a sector is
// read with probability 1 - (1 - 1/(16 F))^128, about 63 % at F = 8,
// whether or not the rest of its lanes are used (and out, 1/F of src's
// size, is written once). The index tables (256 bytes a tile) are read
// once per thread.

#include <cuda_runtime.h>
#include <stdint.h>

#define KP_LANES 128

__global__ void kpayload(const float* __restrict__ src,
                         const int8_t* __restrict__ idx,
                         const uint8_t* __restrict__ sel,
                         float* __restrict__ out, int F, int k) {
  const int64_t t = blockIdx.x;
  const int l = threadIdx.x;
  const int il = idx[t * KP_LANES + l];
  const int sl = sel[t * KP_LANES + l];
  const float* s = src + ((t * F + sl) * (int64_t)k) * KP_LANES + il;
  float* o = out + t * (int64_t)k * KP_LANES + l;
  for (int j = threadIdx.y; j < k; j += blockDim.y)
    o[(int64_t)j * KP_LANES] = __ldg(s + (int64_t)j * KP_LANES);
}

extern "C" {

// rows: threadIdx.y extent (blockDim = (128, rows)). Returns
// cudaGetLastError() after the launch.
int kpayload_f32(const void* src, const void* idx, const void* sel, void* out,
                 int64_t ntiles, int F, int k, int rows, void* stream) {
  if (ntiles < 1 || ntiles > 2147483647 || F < 1 || k < 1 || rows < 1 ||
      rows * KP_LANES > 1024)
    return (int)cudaErrorInvalidValue;
  dim3 block(KP_LANES, rows);
  kpayload<<<(unsigned)ntiles, block, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int8_t*)idx, (const uint8_t*)sel,
      (float*)out, F, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
