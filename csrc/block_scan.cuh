// Warp-shuffle scans shared by the one-block glue kernels
// (csrc/smem_glue.cu reseed_tasks_kernel, csrc/extend.cu
// ext_pairs_kernel). Such a kernel runs one block that loops over the
// reads in chunks of blockDim.x, a thread a read: each chunk's counts are
// scanned by block_inclusive and the chunk's total is carried to the next
// chunk. No block waits on another's result, so nothing rests on the
// order in which blocks are dispatched. Written by hand, no CUB.
#pragma once

#include <cuda_runtime.h>

namespace scan {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

// Inclusive sum of v over the lanes of a full warp.
__device__ __forceinline__ int warp_inclusive(int v, int lane) {
  for (int d = 1; d < WARP; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Inclusive sum of v over the block's threads (blockDim.x a multiple of 32,
// at most 1,024): a shuffle scan in each warp, then one warp scans the
// warp totals in `warp_inc` (32 ints of shared memory). *total gets the
// block's sum. Every thread of the block calls it; it synchronises the
// block, and once more before it returns, so `warp_inc` may be reused by
// the next call.
__device__ __forceinline__ int block_inclusive(int v, int* warp_inc,
                                              int* total) {
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP;
  const int nw = blockDim.x / WARP;
  const int inc = warp_inclusive(v, lane);
  if (lane == WARP - 1) warp_inc[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int x = warp_inclusive(lane < nw ? warp_inc[lane] : 0, lane);
    if (lane < nw) warp_inc[lane] = x;
  }
  __syncthreads();
  const int out = (w ? warp_inc[w - 1] : 0) + inc;
  *total = warp_inc[nw - 1];
  __syncthreads();
  return out;
}

}  // namespace scan
