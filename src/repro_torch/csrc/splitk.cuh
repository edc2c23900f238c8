// Deterministic split-K for the GEMM kernels (aio_matmul.cu,
// grouped_matmul.cu). A launch splits K into slices, one block per (output
// tile, slice). Every block stores its partial tile in a workspace
// (slice, row, column) and arrives on its tile's counter; the last block to
// arrive sums the slices in index order, ((p0 + p1) + p2) + ..., so the
// result does not depend on which block finished last, and writes the
// output. No float atomics. The counters (int32, one per output tile) are
// zero before a launch and the last block of each tile sets its counter
// back to zero, so one zeroed buffer serves every launch on a stream.
#pragma once
#include <cuda_runtime.h>

// Block-wide: publish this block's partial stores and count the block in;
// true in every thread of the block that arrived last of `target`.
__device__ __forceinline__ bool splitk_arrive(int* counter, int target) {
  __shared__ int s_last;
  __threadfence();   // this thread's partial stores before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(counter, 1) == target - 1;
    if (last) *counter = 0;   // every block of the tile has arrived
    s_last = last;
  }
  __syncthreads();
  const bool last = s_last != 0;
  if (last) __threadfence();  // the others' partials before our reads
  return last;
}
