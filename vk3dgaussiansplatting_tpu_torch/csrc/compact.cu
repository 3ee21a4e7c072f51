// Packed-layout copies of the capped path (K5, K6).
//
// Replace the TPU kernels vk3dgaussiansplatting_tpu/ops/pallas/
// compact_kernel.py : compact_runs (_compact_runs_kernel) and
// compact_segments (_compact_kernel).  Both copy int64 slot values (sorted
// gaussian ids) from an [E] source into a packed [ep] array; source slots
// at or past E read 0, as the TPU wrappers' zero padding does.
//
// K5 compact_runs: for each tile t in order, out[sbase_t + i] =
// src[astart_t + i] for i in [0, wmax), astart_t = floor(start_t/128)*128,
// and a later tile's window overwrites an earlier tile's overrun.  The TPU
// kernel serialises its per-tile DMA stores to get that order.  Here one
// thread per output lane finds the lane's owner instead: sbase is
// non-decreasing, so the last writer of lane p is the last t with
// sbase_t <= p (a binary search over the [T] table), provided
// p < sbase_t + wmax; no tile writes the lane otherwise and it holds 0.  The
// stores are one coalesced pass with no ordering between threads.
//
// K6 compact_segments: out[128*j + l] = src[src0_j + l], one thread per
// output lane.
//
// What bounds both on the H100: bytes, 8 read and 8 written per lane (6.3M
// lanes at garden shapes is ~100 MB); the [T] search table stays in L1/L2.
// The wrappers (ops/cuda/compact_kernel.py) clip the offsets as the TPU
// wrappers do before the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;

__global__ void __launch_bounds__(kThreads)
compact_runs_kernel(const int64_t* __restrict__ src, int64_t e,
                    const int64_t* __restrict__ astarts, const int64_t* __restrict__ sbases,
                    int64_t nt, int64_t ep, int64_t wmax, int64_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= ep) return;
  int64_t lo = 0, hi = nt;  // first t with sbases[t] > p
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (sbases[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int64_t v = 0;
  if (lo > 0) {
    const int64_t d = p - sbases[lo - 1];
    if (d < wmax) {
      const int64_t i = astarts[lo - 1] + d;
      if (i < e) v = src[i];
    }
  }
  out[p] = v;
}

__global__ void __launch_bounds__(kThreads)
compact_segments_kernel(const int64_t* __restrict__ src, int64_t e,
                        const int64_t* __restrict__ src0, int64_t ep,
                        int64_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= ep) return;
  const int64_t i = src0[p / kChunk] + p % kChunk;
  out[p] = i < e ? src[i] : 0;
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int vk3d_compact_runs(const void* src, int64_t e, const void* astarts,
                                 const void* sbases, int64_t nt, int64_t ep, int64_t wmax,
                                 void* out, int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ep <= 0) return static_cast<int>(cudaSuccess);
  compact_runs_kernel<<<blocks_for(ep), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(src), e, static_cast<const int64_t*>(astarts),
      static_cast<const int64_t*>(sbases), nt, ep, wmax, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vk3d_compact_segments(const void* src, int64_t e, const void* src0, int64_t ep,
                                     void* out, int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ep <= 0) return static_cast<int>(cudaSuccess);
  compact_segments_kernel<<<blocks_for(ep), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(src), e, static_cast<const int64_t*>(src0), ep,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
