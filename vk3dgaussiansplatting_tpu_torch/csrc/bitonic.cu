// Bitonic merge sort of the sort elements (the SortAlgorithm.BITONIC tier).
//
// Replaces vk3dgaussiansplatting_tpu/ops/bitonic.py : sort_elements_bitonic,
// an XLA function of the JAX package (no Pallas kernel): the flip/disperse
// compare-exchange network, one XLA fusion a stage.  Here the network runs
// on the reference renderer's dispatch schedule (BitonicMergeSort.cpp:
// 103-149), with a block of B = kBlock elements in shared memory:
//
//   LOCAL_BMS       one pass: each block of B elements sorted in shared
//                   memory through every k <= B (flip, then disperses);
//   for k = 2B .. E:
//     BIG_FLIP      one global pass, the mirrored distance k/2;
//     BIG_DISPERSE  one global pass a distance j, k/4 >= j >= B;
//     LOCAL_DISPERSE one pass: every distance j < B of the block, in shared
//                   memory.
//
// That is 1 + sum over k of (2 + log2(k / 4B) + 1) launches: 105 at
// E = 2^24 and 91 at 2^23 with B = 2048 (ops/cuda/bitonic_kernel.py,
// planned_passes).  Every launch reads and writes each element once.
//
// Elements: the port carries tile, depth and index as uint32 values in
// int64 columns.  The first pass packs them into a 64-bit key
// (tile << 32) | depth, compared unsigned, and a uint32 index (12 B an
// element, two scratch arrays); the last pass unpacks into new int64
// columns, so the inputs are never written.  The compare is the full
// (tile, depth, index) triple, the JAX tier's tie-break (bitonic.py:33-35;
// the reference compares the 64-bit key only), so SENTINEL (0xFFFFFFFF) is
// the largest value of each column and the order is total: any correct
// sort of these triples gives the same array, bit for bit.  Integer work
// only, no atomics: the result is deterministic.
//
// What bounds it on the H100: bytes.  The function's floor is 48 B an
// element (three int64 columns in, three out); the network's own floor is
// its passes x 24 B an element.  This first version keeps one global pass a
// distance >= B; fusing several distances into one pass, larger blocks and
// TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;                 // threads of a shared-memory pass
constexpr int kBlock = 2 * kThreads;           // B: elements a block sorts in shared memory
constexpr int kGlobalThreads = 256;            // threads of a global pass, one pair each

__device__ __forceinline__ bool key_less(uint64_t ka, uint32_t ia, uint64_t kb, uint32_t ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// Pair p of a stage at distance d: its lower slot a; its partner is a + d
// (disperse) or the mirror of a in the 2d-block (flip).
__host__ __device__ __forceinline__ int64_t pair_low(int64_t p, int64_t d) {
  return ((p & ~(d - 1)) << 1) | (p & (d - 1));
}

template <bool kFlip>
__device__ __forceinline__ int64_t pair_high(int64_t p, int64_t d) {
  if constexpr (kFlip) return pair_low(p, d) + 2 * d - 1 - 2 * (p & (d - 1));
  return pair_low(p, d) + d;
}

// Compare-exchange of slots a < b: the smaller triple to a.
template <typename K, typename I>
__device__ __forceinline__ void compare_exchange(K* keys, I* idx, int64_t a, int64_t b) {
  const uint64_t ka = keys[a], kb = keys[b];
  const uint32_t ia = idx[a], ib = idx[b];
  if (key_less(kb, ib, ka, ia)) {
    keys[a] = kb;
    keys[b] = ka;
    idx[a] = ib;
    idx[b] = ia;
  }
}

// One stage over the n elements in shared memory (n / 2 <= kThreads pairs).
template <bool kFlip>
__device__ __forceinline__ void shared_stage(uint64_t* s_key, uint32_t* s_idx, int n, int d) {
  const int p = threadIdx.x;
  if (p < n / 2) compare_exchange(s_key, s_idx, pair_low(p, d), pair_high<kFlip>(p, d));
  __syncthreads();
}

// A shared-memory pass over each block of n = min(E, B) elements: LOCAL_BMS
// (kMerge false: sort the block, k = 2 .. n) or LOCAL_DISPERSE (kMerge
// true: distances n/2 .. 1 of a larger k).  kFromCols reads the int64
// columns and packs them; kToCols unpacks into the output columns.
template <bool kFromCols, bool kToCols, bool kMerge>
__global__ void __launch_bounds__(kThreads)
bitonic_local_kernel(const int64_t* __restrict__ tile, const int64_t* __restrict__ depth,
                     const int64_t* __restrict__ index, uint64_t* __restrict__ keys,
                     uint32_t* __restrict__ idx, int64_t* __restrict__ out_tile,
                     int64_t* __restrict__ out_depth, int64_t* __restrict__ out_index, int n) {
  __shared__ uint64_t s_key[kBlock];
  __shared__ uint32_t s_idx[kBlock];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int64_t g = base + q;
    if constexpr (kFromCols) {
      s_key[q] = (static_cast<uint64_t>(tile[g]) << 32) | static_cast<uint32_t>(depth[g]);
      s_idx[q] = static_cast<uint32_t>(index[g]);
    } else {
      s_key[q] = keys[g];
      s_idx[q] = idx[g];
    }
  }
  __syncthreads();
  if constexpr (kMerge) {
    for (int j = n >> 1; j >= 1; j >>= 1) shared_stage<false>(s_key, s_idx, n, j);
  } else {
    for (int k = 2; k <= n; k <<= 1) {
      shared_stage<true>(s_key, s_idx, n, k >> 1);
      for (int j = k >> 2; j >= 1; j >>= 1) shared_stage<false>(s_key, s_idx, n, j);
    }
  }
  for (int q = threadIdx.x; q < n; q += kThreads) {
    const int64_t g = base + q;
    if constexpr (kToCols) {
      out_tile[g] = static_cast<int64_t>(s_key[q] >> 32);
      out_depth[g] = static_cast<int64_t>(s_key[q] & 0xFFFFFFFFull);
      out_index[g] = static_cast<int64_t>(s_idx[q]);
    } else {
      keys[g] = s_key[q];
      idx[g] = s_idx[q];
    }
  }
}

// BIG_FLIP (kFlip, d = k/2) or BIG_DISPERSE (d = j) over the packed arrays:
// one thread a pair.
template <bool kFlip>
__global__ void __launch_bounds__(kGlobalThreads)
bitonic_global_kernel(uint64_t* __restrict__ keys, uint32_t* __restrict__ idx, int64_t pairs,
                      int64_t d) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kGlobalThreads + threadIdx.x;
  if (p >= pairs) return;
  compare_exchange(keys, idx, pair_low(p, d), pair_high<kFlip>(p, d));
}

}  // namespace

// Sorts [e] elements (e a power of two) from the int64 columns tile, depth,
// index into out_*; keys ([e] uint64) and idx ([e] uint32) are scratch,
// used (and may be NULL otherwise) when e > kBlock.  *launches receives the
// number of kernels launched.
extern "C" int vk3d_bitonic_sort(const void* tile, const void* depth, const void* index,
                                 int64_t e, void* keys, void* idx, void* out_tile,
                                 void* out_depth, void* out_index, int64_t* launches,
                                 int32_t device, void* stream) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e <= 0) return static_cast<int>(cudaSuccess);
  if (e & (e - 1)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int64_t*>(tile);
  const auto* dp = static_cast<const int64_t*>(depth);
  const auto* ix = static_cast<const int64_t*>(index);
  auto* k64 = static_cast<uint64_t*>(keys);
  auto* i32 = static_cast<uint32_t*>(idx);
  auto* ot = static_cast<int64_t*>(out_tile);
  auto* od = static_cast<int64_t*>(out_depth);
  auto* oi = static_cast<int64_t*>(out_index);
  if (e <= kBlock) {  // one block: LOCAL_BMS from the columns to the columns
    bitonic_local_kernel<true, true, false><<<1, kThreads, 0, s>>>(
        t, dp, ix, nullptr, nullptr, ot, od, oi, static_cast<int>(e));
    ++*launches;
    return static_cast<int>(cudaGetLastError());
  }
  const auto blocks = static_cast<unsigned int>(e / kBlock);
  bitonic_local_kernel<true, false, false><<<blocks, kThreads, 0, s>>>(
      t, dp, ix, k64, i32, nullptr, nullptr, nullptr, kBlock);
  ++*launches;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = e / 2;
  const auto pair_blocks = static_cast<unsigned int>((pairs + kGlobalThreads - 1) / kGlobalThreads);
  for (int64_t k = 2 * kBlock; k <= e; k <<= 1) {
    bitonic_global_kernel<true><<<pair_blocks, kGlobalThreads, 0, s>>>(k64, i32, pairs, k >> 1);
    ++*launches;
    for (int64_t j = k >> 2; j >= kBlock; j >>= 1) {
      bitonic_global_kernel<false><<<pair_blocks, kGlobalThreads, 0, s>>>(k64, i32, pairs, j);
      ++*launches;
    }
    if (k == e) {
      bitonic_local_kernel<false, true, true><<<blocks, kThreads, 0, s>>>(
          nullptr, nullptr, nullptr, k64, i32, ot, od, oi, kBlock);
    } else {
      bitonic_local_kernel<false, false, true><<<blocks, kThreads, 0, s>>>(
          nullptr, nullptr, nullptr, k64, i32, nullptr, nullptr, nullptr, kBlock);
    }
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
