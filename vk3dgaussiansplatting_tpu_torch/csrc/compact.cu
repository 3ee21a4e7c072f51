// Packed-layout copies of the capped path (K5, K6).
//
// Replace the TPU kernels vk3dgaussiansplatting_tpu/ops/pallas/
// compact_kernel.py : compact_runs (_compact_runs_kernel) and
// compact_segments (_compact_kernel).  All copy int64 slot values (sorted
// gaussian ids) from an [E] source into a packed [ep] array; source slots
// at or past E read 0, as the TPU wrappers' zero padding does.
//
// K5 compact_slabs (the capped layout's call): tile t owns the slab
// [sbase_t, sbase_t + slabw_t) and writes all of it, the ids of its live
// lanes [sbase_t + off_t, + counts_t) and SENTINEL on the rest; lanes past
// the last slab, up to ep, are SENTINEL too, and nothing is written at or
// past ep (an overflowing layout is clipped).  The layout's slabs are the
// exclusive scan of their widths, so they tile [0, pcum_end) with no gap
// and no overlap, and the TPU kernel's ordering problem (a later tile's
// window overwriting an earlier tile's overrun, which it solves by
// serialising its stores) does not arise: one block per slab, in any order,
// and the tail blocks after them.  A lane's id is src[astart_t + (p -
// sbase_t)] with astart_t = floor(start_t / 128) * 128, as in compact_runs.
// sbase_t and astart_t are multiples of 128, so a thread's two lanes are a
// 16-byte load and a 16-byte store, and each thread keeps four such pairs
// in flight: a slab of cap_max lanes (or a patch slab of 16,384) costs a
// few load latencies, where one pair a step cost one latency a step.
//
// K5 compact_runs (the TPU function, unmasked): for each tile t in order,
// out[sbase_t + i] = src[astart_t + i] for i in [0, wmax), a later tile's
// window overwriting an earlier tile's overrun.  One thread per output lane
// finds the lane's owner: sbase is non-decreasing, so the last writer of
// lane p is the last t with sbase_t <= p (a binary search over the [T]
// table), provided p < sbase_t + wmax; no tile writes the lane otherwise
// and it holds 0.  No path runs it since compact_slabs took the layout.
//
// K6 compact_segments: out[128*j + l] = src[src0_j + l], one thread per
// output lane.
//
// What bounds all three on the H100: bytes.  compact_slabs writes 8 bytes
// a lane and reads 8 a live lane, plus its five [T] tables (5.98M live of
// 7.24M lanes at garden's steady frame is ~106 MB); the unmasked copies
// read and write 8 bytes a lane.  The source offsets are clipped as the TPU
// wrappers clip them: by compact_slabs itself, and for the other two by
// their wrappers (ops/cuda/compact_kernel.py) before the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;
constexpr int kSlabThreads = 256;
constexpr int64_t kStep = 2 * kSlabThreads;  // a lane pair a thread
constexpr int kUnroll = 4;                   // pairs a thread in flight
constexpr int kTailBlocks = 264;             // 2 a streaming multiprocessor
constexpr int64_t kSentinel = 0xFFFFFFFFll;  // core/config.py SENTINEL

__global__ void __launch_bounds__(kSlabThreads)
compact_slabs_kernel(const int64_t* __restrict__ src, int64_t e, bool src_aligned,
                     const int64_t* __restrict__ starts, int64_t starts_stride,
                     const int64_t* __restrict__ sbases,
                     const int64_t* __restrict__ slabw, const int64_t* __restrict__ offs,
                     const int64_t* __restrict__ counts, int64_t nt, int64_t ep,
                     int64_t* __restrict__ out) {
  const int64_t b = blockIdx.x;
  if (b >= nt) {  // the tail [pcum_end, ep), grid-strided over the tail blocks
    const int64_t pend = nt > 0 ? sbases[nt - 1] + slabw[nt - 1] : 0;
    const int64_t stride = 2ll * kSlabThreads * (gridDim.x - nt);
    const longlong2 dead = make_longlong2(kSentinel, kSentinel);
    for (int64_t p = (pend < 0 ? 0 : pend) + 2ll * ((b - nt) * kSlabThreads + threadIdx.x);
         p < ep; p += stride) {
      *reinterpret_cast<longlong2*>(out + p) = dead;
    }
    return;
  }
  const int64_t base = sbases[b];
  const int64_t slab_end = base + slabw[b];
  const int64_t end = slab_end < ep ? slab_end : ep;
  const int64_t lo = base + offs[b];
  const int64_t hi = lo + counts[b];
  // astart = floor(start / 128) * 128, clipped to [0, ceil(E / 128) * 128]
  // as the TPU wrapper clips it (compact_kernel.py:147-148).
  const int64_t start = starts[b * starts_stride];
  const int64_t e_ceil = (e + kChunk - 1) / kChunk * kChunk;
  const int64_t aligned = start / kChunk * kChunk;
  const int64_t astart = start < 0 ? 0 : (aligned < e_ceil ? aligned : e_ceil);
  const int64_t shift = astart - base;  // lane p reads src[shift + p]
  // kUnroll lane pairs a thread a step, their loads started before any
  // store: a long slab costs a few load latencies, not one per pair.
  for (int64_t p0 = base + 2 * threadIdx.x; p0 < end; p0 += kUnroll * kStep) {
    longlong2 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t p = p0 + k * kStep;
      v[k] = make_longlong2(kSentinel, kSentinel);
      const bool live0 = p < end && p >= lo && p < hi;
      const bool live1 = p + 1 < end && p + 1 >= lo && p + 1 < hi;
      const int64_t i = shift + p;
      if (live0 && live1 && src_aligned && i + 1 < e) {
        v[k] = __ldg(reinterpret_cast<const longlong2*>(src + i));
      } else {
        if (live0) v[k].x = i < e ? src[i] : 0;
        if (live1) v[k].y = i + 1 < e ? src[i + 1] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t p = p0 + k * kStep;
      if (p < end) *reinterpret_cast<longlong2*>(out + p) = v[k];
    }
  }
}

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

extern "C" int vk3d_compact_slabs(const void* src, int64_t e, const void* starts,
                                  int64_t starts_stride, const void* sbases, const void* slabw,
                                  const void* offs, const void* counts, int64_t nt, int64_t ep,
                                  void* out, int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ep <= 0) return static_cast<int>(cudaSuccess);
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  compact_slabs_kernel<<<static_cast<unsigned int>(nt + kTailBlocks), kSlabThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(src), e, aligned, static_cast<const int64_t*>(starts),
      starts_stride, static_cast<const int64_t*>(sbases), static_cast<const int64_t*>(slabw),
      static_cast<const int64_t*>(offs), static_cast<const int64_t*>(counts), nt, ep,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

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
