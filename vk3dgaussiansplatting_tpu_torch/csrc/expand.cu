// Monotone fixed-capacity expansion — the InitSortList element allocation.
//
// Replaces the TPU kernel vk3dgaussiansplatting_tpu/ops/pallas/expand_kernel.py
// : expand_rows (_expand_kernel).  Computes, for ncols int32 columns of N
// source rows and the inclusive int64 scan `cum` of their counts,
//
//     out[c][j] = cols[c][r(j)],  r(j) = #{i : cum[i] <= j},  j < min(total, E)
//     out[c][j] = 0,                                          otherwise
//
// i.e. repeat(cols, counts, total_repeat_length=E) with zeros in dead slots,
// in jnp.repeat's slot order.
//
// What bounds it on the H100: the bytes written, ncols * 4 * E (6 columns at
// E = 14.2M is 340 MB), plus one gathered row read per slot.
//
// Design: one thread per output SLOT, finding its source row by binary
// search over the scan (no atomics, so the slot order is the scan's).  A
// thread per source row would write its run [off_i, off_i + count_i) alone,
// so a gaussian covering thousands of tiles would serialise on one thread,
// and its stores would not coalesce; per slot, every warp stores 32
// consecutive int32 per column and the work per thread is the same whatever
// the run lengths.  The block first brackets the rows of its own 256 slots
// (two searches over the whole scan, by threads 0 and 1) so each thread
// searches only that bracket, which stays in L1/L2.
//
// The TPU kernel's 512-slot windows, scalar-prefetched spans and lane
// crossbars were answers to the TPU's DMA and gather costs and are not
// carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// First index i in [lo, hi) with cum[i] > j (hi if none).
__device__ __forceinline__ int64_t upper_bound(const int64_t* __restrict__ cum,
                                               int64_t lo, int64_t hi, int64_t j) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (cum[mid] <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const int32_t* __restrict__ cols, int ncols,
                   const int64_t* __restrict__ cum, int64_t n, int64_t capacity,
                   int32_t* __restrict__ out) {
  __shared__ int64_t s_lo, s_hi;
  const int64_t total = n > 0 ? cum[n - 1] : 0;
  const int64_t live = total < capacity ? total : capacity;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t j = j0 + threadIdx.x;

  if (j0 >= live) {  // the whole block is past the live total
    if (j < capacity) {
      for (int c = 0; c < ncols; ++c) out[c * capacity + j] = 0;
    }
    return;
  }
  const int64_t j_last = (j0 + kThreads < live ? j0 + kThreads : live) - 1;
  if (threadIdx.x == 0) s_lo = upper_bound(cum, 0, n, j0);
  if (threadIdx.x == 1) s_hi = upper_bound(cum, 0, n, j_last) + 1;
  __syncthreads();

  if (j >= capacity) return;
  if (j < live) {
    const int64_t r = upper_bound(cum, s_lo, s_hi, j);
    for (int c = 0; c < ncols; ++c) out[c * capacity + j] = cols[c * n + r];
  } else {
    for (int c = 0; c < ncols; ++c) out[c * capacity + j] = 0;
  }
}

}  // namespace

extern "C" int vk3d_expand_rows(const void* cols, int32_t ncols, const void* cum,
                                int64_t n, int64_t capacity, void* out,
                                int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (capacity <= 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (capacity + kThreads - 1) / kThreads;
  expand_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), ncols, static_cast<const int64_t*>(cum), n,
      capacity, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vk3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
