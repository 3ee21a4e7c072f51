// Bitonic merge sort of the sort elements (the SortAlgorithm.BITONIC tier).
//
// Replaces vk3dgaussiansplatting_tpu/ops/bitonic.py : sort_elements_bitonic,
// an XLA function of the JAX package (no Pallas kernel): the flip/disperse
// compare-exchange network, one XLA fusion a stage.
//
// The network is written in its XOR form: stage (k, j) compares slot i with
// slot i ^ j, ascending where (i & k) == 0, for k = 2 .. E and j = k/2 .. 1.
// Every stage, the JAX tier's flip included, is then an exchange at one
// distance, so consecutive distances fuse into one pass.  The arrays between
// stages differ from the JAX tier's; the sorted array does not (below).
//
// Departure from the reference renderer's dispatch schedule
// (BitonicMergeSort.cpp:103-149, one dispatch a distance >= its block), with
// a block of B = 2^13 elements in 96 KB of dynamic shared memory:
//
//   first   one pass: each block of min(E, B) elements sorted, every k <= B;
//   for k = 2B .. E:
//     global  one pass a group of up to kGroup = 5 distances k/2 .. B, from
//             the largest (a k's last group may be shorter): each thread
//             loads the 2^g slots base + u * s (s the group's smallest
//             distance), runs the g stages in registers and stores each
//             slot once;
//     merge   one pass: the distances B/2 .. 1 of the block.
//
// That is 30 kernels at E = 2^24 and 26 at 2^23 (ops/cuda/bitonic_kernel.py,
// schedule / planned_passes).  A shared pass holds 32 elements a thread in
// registers, 256 threads a block.  A thread's 32 elements in layout L are
// the block slots whose bits L .. L+4 are its register index and whose
// other bits are its thread id; the stages at distances 2^L .. 2^(L+4) run
// in registers, and the elements are re-mapped through shared memory (three
// uint32 arrays, 12 B a slot, XOR-swizzled so that no layout's warp access
// has a bank conflict) when a stage's distance leaves the layout: a merge
// runs in layouts 8, 3 and 0, then re-maps to layout 8, whose loads and
// stores are coalesced.  A merge fits 128 registers a thread, so two blocks
// share an SM and one's loads and stores overlap the other's stages; the
// first pass, whose loop carries more, takes up to 255 and runs alone.
// B = 2^14 (512 threads, one block an SM) led while a block ran alone on
// its SM, and lost once the 2^13 merges ran two to an SM; its first pass
// spilled at the 128 registers 512 threads leave a thread.
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
// its passes x 24 B an element, which the fused global passes cut from the
// reference schedule's 105 passes to 30 at E = 2^24.  The shared passes run
// below the memory rate: their compare-exchanges are integer work, and a
// block's loads, stages and stores take turns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogBlock = 13;              // B = 2^13 elements a shared pass's block
constexpr int kPerLog = 5;                 // a shared pass's thread holds 2^5 elements
constexpr int kPer = 1 << kPerLog;
constexpr int kTop = kLogBlock - kPerLog;  // the coalesced layout
constexpr int kSharedThreads = 1 << kTop;
constexpr int kGroup = 5;                  // distances a global pass fuses
constexpr int kGlobalThreads = 256;

// An element in registers: the key's high word (tile), its low word (depth)
// and the index, three 32-bit registers.

// Whether (hb, lb, ib) < (ha, la, ia) as 96-bit unsigned numbers: the borrow
// out of their difference, one carry chain over the three words.
__device__ __forceinline__ bool precedes(uint32_t hb, uint32_t lb, uint32_t ib, uint32_t ha,
                                         uint32_t la, uint32_t ia) {
  uint32_t borrow;
  asm("{\n\t.reg .u32 t, z;\n\t"
      "mov.u32 z, 0;\n\t"
      "sub.cc.u32 t, %1, %2;\n\t"
      "subc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %5, %6;\n\t"
      "subc.u32 %0, z, z;\n\t}"
      : "=r"(borrow)
      : "r"(ib), "r"(ia), "r"(lb), "r"(la), "r"(hb), "r"(ha));
  return borrow != 0;
}

// The smaller element of a pair to a where `ascending`, the larger
// elsewhere.  Equal triples are the same values, so swapping them is
// harmless: one comparison decides, and selects, not a branch, move them.
__device__ __forceinline__ void compare_exchange(uint32_t& ha, uint32_t& la, uint32_t& ia,
                                                 uint32_t& hb, uint32_t& lb, uint32_t& ib,
                                                 bool ascending) {
  const bool swap = precedes(hb, lb, ib, ha, la, ia) == ascending;
  const uint32_t h0 = swap ? hb : ha, h1 = swap ? ha : hb;
  const uint32_t l0 = swap ? lb : la, l1 = swap ? la : lb;
  const uint32_t i0 = swap ? ib : ia, i1 = swap ? ia : ib;
  ha = h0;
  hb = h1;
  la = l0;
  lb = l1;
  ia = i0;
  ib = i1;
}

// Registers u and v of the arrays.
#define VK3D_PAIR(u, v) hi[u], lo[u], ix[u], hi[v], lo[v], ix[v]

// ---- global passes ---------------------------------------------------------

// One group of G stages, distances 2^(lo_bit+G-1) .. 2^lo_bit of one k > B:
// thread `tid` owns the slots base + u * 2^lo_bit, u < 2^G, where base is
// tid with the bits lo_bit .. lo_bit+G-1 cleared.  k lies above the group's bits, so the
// direction is the thread's.
template <int G>
__global__ void __launch_bounds__(kGlobalThreads)
bitonic_global_kernel(uint64_t* __restrict__ keys, uint32_t* __restrict__ idx, int64_t threads,
                      int64_t k, int lo_bit) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kGlobalThreads + threadIdx.x;
  if (tid >= threads) return;
  const int64_t s = int64_t{1} << lo_bit;
  const int64_t base = ((tid >> lo_bit) << (lo_bit + G)) | (tid & (s - 1));
  const bool ascending = (base & k) == 0;
  uint32_t hi[1 << G], lo[1 << G], ix[1 << G];
#pragma unroll
  for (int u = 0; u < (1 << G); ++u) {
    const uint64_t key = keys[base + u * s];
    hi[u] = static_cast<uint32_t>(key >> 32);
    lo[u] = static_cast<uint32_t>(key);
    ix[u] = idx[base + u * s];
  }
#pragma unroll
  for (int m = G - 1; m >= 0; --m) {
#pragma unroll
    for (int u = 0; u < (1 << G); ++u) {
      if (u & (1 << m)) continue;
      compare_exchange(VK3D_PAIR(u, u | (1 << m)), ascending);
    }
  }
#pragma unroll
  for (int u = 0; u < (1 << G); ++u) {
    keys[base + u * s] = (static_cast<uint64_t>(hi[u]) << 32) | lo[u];
    idx[base + u * s] = ix[u];
  }
}

// ---- shared-memory passes --------------------------------------------------
//
// A block of B slots held by B / 32 threads of 32 elements.  In layout L,
// thread t's register u holds block slot layout_base(t, L) | u << L, so the
// stages at distances 2^L .. 2^(L+4) run in registers.  A stage whose
// distance is outside the current layout re-maps the registers through
// shared memory to layout_for's.

__device__ __forceinline__ uint32_t layout_base(uint32_t t, int layout) {
  return ((t >> layout) << (layout + kPerLog)) | (t & ((1u << layout) - 1u));
}

// The layout a stage at distance 2^x runs in: 0 below 2^5, else the largest
// of kTop, kTop - 5, ... at or below x, so a merge runs in layouts 8, 3, 0.
__device__ __forceinline__ int layout_for(int x) {
  if (x < kPerLog) return 0;
  return kTop - kPerLog * ((kTop - x + kPerLog - 1) / kPerLog);
}

// Shared-memory word of slot p: its bits 0..4 XORed with bits 5..9.  A warp
// holds one register index, so its 32 lanes' slots differ in the thread
// bits that fall on slot bits 0..9 (layout L >= 5: bits 0..4; L < 5: bits
// 0..L-1 and L+5..9), which the XOR maps to 32 distinct banks.
__device__ __forceinline__ uint32_t swizzle(uint32_t p) { return p ^ ((p >> 5) & 31u); }

// Moves the registers from layout `from` to layout `to` through shared
// memory (s: the high words, then the low words, then the indices, B each).
__device__ __forceinline__ void relayout(uint32_t (&hi)[kPer], uint32_t (&lo)[kPer],
                                         uint32_t (&ix)[kPer], uint32_t* s, uint32_t t,
                                         int from, int to) {
  constexpr uint32_t kB = 1u << kLogBlock;
  __syncthreads();  // the previous re-map's reads are done
  uint32_t pb = layout_base(t, from);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const uint32_t q = swizzle(pb | (static_cast<uint32_t>(u) << from));
    s[q] = hi[u];
    s[kB + q] = lo[u];
    s[2 * kB + q] = ix[u];
  }
  __syncthreads();
  pb = layout_base(t, to);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const uint32_t q = swizzle(pb | (static_cast<uint32_t>(u) << to));
    hi[u] = s[q];
    lo[u] = s[kB + q];
    ix[u] = s[2 * kB + q];
  }
}

// Registers, a bit each, whose pair runs descending in a stage of k = 2^lk
// in layout b: slot i = base + (layout_base(t, b) | u << b) descends where
// bit lk of i is set, which is the block's bit for k >= B, a register bit
// for b <= lk < b+5 (the thread's part is zero there) and the thread's
// otherwise.
__device__ __forceinline__ uint32_t descending(uint32_t t, int b, int lk) {
  if (lk >= kLogBlock) return (blockIdx.x >> (lk - kLogBlock)) & 1u ? ~0u : 0u;
  switch (lk - b) {
    case 0: return 0xAAAAAAAAu;
    case 1: return 0xCCCCCCCCu;
    case 2: return 0xF0F0F0F0u;
    case 3: return 0xFF00FF00u;
    case 4: return 0xFFFF0000u;
    default: return (layout_base(t, b) >> lk) & 1u ? ~0u : 0u;
  }
}

// The stage at register bit M: register u against u | 1 << M.
template <int M>
__device__ __forceinline__ void register_stage(uint32_t (&hi)[kPer], uint32_t (&lo)[kPer],
                                               uint32_t (&ix)[kPer], uint32_t desc) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (u & (1 << M)) continue;
    compare_exchange(VK3D_PAIR(u, u | (1 << M)), !((desc >> u) & 1u));
  }
}

// Stage (2^lk, 2^x) of a shared pass, re-mapping first if 2^x is outside
// the current layout b.
__device__ __forceinline__ void shared_stage(uint32_t (&hi)[kPer], uint32_t (&lo)[kPer],
                                             uint32_t (&ix)[kPer], uint32_t* s, uint32_t t,
                                             int& b, int lk, int x) {
  if (x < b || x >= b + kPerLog) {
    const int to = layout_for(x);
    relayout(hi, lo, ix, s, t, b, to);
    b = to;
  }
  const uint32_t desc = descending(t, b, lk);
  switch (x - b) {
    case 0: register_stage<0>(hi, lo, ix, desc); break;
    case 1: register_stage<1>(hi, lo, ix, desc); break;
    case 2: register_stage<2>(hi, lo, ix, desc); break;
    case 3: register_stage<3>(hi, lo, ix, desc); break;
    default: register_stage<4>(hi, lo, ix, desc); break;
  }
}

// A shared pass over each block of n = min(E, B) elements.  kFromCols: the
// first pass, reading and packing the int64 columns and sorting the block
// through every k <= B (a lone block shorter than B is padded with all-ones
// triples, which sort last and are never stored); else a merge of the
// scratch arrays at the distances B/2 .. 1 of k = 2^lk.  kToCols unpacks
// into the output columns.  The columns' values are uint32 (ops/keygen.py),
// so their int64 slots are read and written as 32-bit words: one register
// a value where a 64-bit load takes two.  Loads and stores run in layout
// kTop: consecutive threads, consecutive slots.
template <bool kFromCols, bool kToCols>
__global__ void __launch_bounds__(kSharedThreads, kFromCols ? 1 : 2)
bitonic_shared_kernel(const int64_t* __restrict__ tile, const int64_t* __restrict__ depth,
                      const int64_t* __restrict__ index, uint64_t* __restrict__ keys,
                      uint32_t* __restrict__ idx, int64_t* __restrict__ out_tile,
                      int64_t* __restrict__ out_depth, int64_t* __restrict__ out_index,
                      uint32_t n, int lk) {
  extern __shared__ uint32_t smem[];
  const uint32_t t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << kLogBlock;
  // Only a lone block (E < B) has padding; every other block holds B slots.
  constexpr bool kLone = kFromCols && kToCols;
  uint32_t hi[kPer], lo[kPer], ix[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const uint32_t p = t + (static_cast<uint32_t>(u) << kTop);
    const int64_t g = base + p;
    if (kLone && p >= n) {
      hi[u] = lo[u] = ix[u] = ~0u;
    } else if constexpr (kFromCols) {  // the low word of each int64
      hi[u] = reinterpret_cast<const uint32_t*>(tile)[2 * g];
      lo[u] = reinterpret_cast<const uint32_t*>(depth)[2 * g];
      ix[u] = reinterpret_cast<const uint32_t*>(index)[2 * g];
    } else {
      const uint64_t key = keys[g];
      hi[u] = static_cast<uint32_t>(key >> 32);
      lo[u] = static_cast<uint32_t>(key);
      ix[u] = idx[g];
    }
  }
  int b = kTop;
  // The stage loops stay rolled: a stage is 16 compare-exchanges and maybe
  // a re-map, and unrolled copies would only add registers.
  if constexpr (kFromCols) {
#pragma unroll 1
    for (int l = 1; l <= kLogBlock; ++l) {
#pragma unroll 1
      for (int x = l - 1; x >= 0; --x) shared_stage(hi, lo, ix, smem, t, b, l, x);
    }
  } else {
#pragma unroll 1
    for (int x = kLogBlock - 1; x >= 0; --x) {
      shared_stage(hi, lo, ix, smem, t, b, lk, x);
    }
  }
  if (b != kTop) relayout(hi, lo, ix, smem, t, b, kTop);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const uint32_t p = t + (static_cast<uint32_t>(u) << kTop);
    const int64_t g = base + p;
    if (kLone && p >= n) continue;
    if constexpr (kToCols) {  // each int64 as its two words
      reinterpret_cast<uint32_t*>(out_tile)[2 * g] = hi[u];
      reinterpret_cast<uint32_t*>(out_tile)[2 * g + 1] = 0u;
      reinterpret_cast<uint32_t*>(out_depth)[2 * g] = lo[u];
      reinterpret_cast<uint32_t*>(out_depth)[2 * g + 1] = 0u;
      reinterpret_cast<uint32_t*>(out_index)[2 * g] = ix[u];
      reinterpret_cast<uint32_t*>(out_index)[2 * g + 1] = 0u;
    } else {
      keys[g] = (static_cast<uint64_t>(hi[u]) << 32) | lo[u];
      idx[g] = ix[u];
    }
  }
}

#undef VK3D_PAIR

struct Columns {
  const int64_t* tile;
  const int64_t* depth;
  const int64_t* index;
  uint64_t* keys;
  uint32_t* idx;
  int64_t* out_tile;
  int64_t* out_depth;
  int64_t* out_index;
};

// Shared memory above 48 KB needs the kernel's opt-in; a refused opt-in is
// returned, never worked around with a smaller block.
template <bool kFromCols, bool kToCols>
cudaError_t launch_shared(const Columns& c, uint32_t n, int lk, unsigned int blocks,
                          cudaStream_t s) {
  constexpr int kSmem = 12 << kLogBlock;
  cudaError_t err = cudaFuncSetAttribute(bitonic_shared_kernel<kFromCols, kToCols>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  bitonic_shared_kernel<kFromCols, kToCols><<<blocks, kSharedThreads, kSmem, s>>>(
          c.tile, c.depth, c.index, c.keys, c.idx, c.out_tile, c.out_depth, c.out_index, n, lk);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_global(const Columns& c, int64_t e, int64_t k, int lo, cudaStream_t s) {
  const int64_t threads = e >> G;
  const auto blocks = static_cast<unsigned int>((threads + kGlobalThreads - 1) / kGlobalThreads);
  bitonic_global_kernel<G><<<blocks, kGlobalThreads, 0, s>>>(c.keys, c.idx, threads, k, lo);
  return cudaGetLastError();
}

cudaError_t global_pass(int g, const Columns& c, int64_t e, int64_t k, int lo, cudaStream_t s) {
  switch (g) {
    case 1: return launch_global<1>(c, e, k, lo, s);
    case 2: return launch_global<2>(c, e, k, lo, s);
    case 3: return launch_global<3>(c, e, k, lo, s);
    case 4: return launch_global<4>(c, e, k, lo, s);
    case 5: return launch_global<5>(c, e, k, lo, s);
    default: return cudaErrorInvalidValue;
  }
}

// The whole schedule; *launches counts the kernels.
cudaError_t sort_network(const Columns& c, int64_t e, int64_t* launches, cudaStream_t s) {
  constexpr uint32_t kBlock = 1u << kLogBlock;
  cudaError_t err;
  if (e <= kBlock) {  // one block: the first pass from the columns to the columns
    err = launch_shared<true, true>(c, static_cast<uint32_t>(e), 0, 1, s);
    if (err == cudaSuccess) ++*launches;
    return err;
  }
  const auto blocks = static_cast<unsigned int>(e >> kLogBlock);
  if ((err = launch_shared<true, false>(c, kBlock, 0, blocks, s)) != cudaSuccess) {
    return err;
  }
  ++*launches;
  int lk = kLogBlock + 1;
  for (int64_t k = 2 * int64_t{kBlock}; k <= e; k <<= 1, ++lk) {
    for (int hi = lk - 1; hi >= kLogBlock; hi -= kGroup) {
      const int g = hi - kLogBlock + 1 < kGroup ? hi - kLogBlock + 1 : kGroup;
      if ((err = global_pass(g, c, e, k, hi - g + 1, s)) != cudaSuccess) return err;
      ++*launches;
    }
    err = k == e ? launch_shared<false, true>(c, kBlock, lk, blocks, s)
                 : launch_shared<false, false>(c, kBlock, lk, blocks, s);
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

}  // namespace

// Sorts [e] elements (e a power of two) from the int64 columns tile, depth,
// index into out_*; keys ([e] uint64) and idx ([e] uint32) are scratch, used (and may be NULL
// otherwise) when e > B = 2^13.  *launches receives the number of kernels
// launched.
extern "C" int vk3d_bitonic_sort(const void* tile, const void* depth, const void* index,
                                 int64_t e, void* keys, void* idx, void* out_tile,
                                 void* out_depth, void* out_index, int64_t* launches,
                                 int32_t device, void* stream) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e & (e - 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (e <= 0) return static_cast<int>(cudaSuccess);
  const Columns c{static_cast<const int64_t*>(tile), static_cast<const int64_t*>(depth),
                  static_cast<const int64_t*>(index), static_cast<uint64_t*>(keys),
                  static_cast<uint32_t*>(idx), static_cast<int64_t*>(out_tile),
                  static_cast<int64_t*>(out_depth), static_cast<int64_t*>(out_index)};
  return static_cast<int>(sort_network(c, e, launches, static_cast<cudaStream_t>(stream)));
}
