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
//     global  the distances k/2 .. B in the fewest passes of up to kGroup = 9
//             distances, their sizes within one of each other (11 as 5 + 6):
//             a register pass (2^g slots of one stride a thread, g <= 5) or
//             a wide pass over blocks of B slots strided through the list
//             so that each block holds both slots of every pair;
//     merge   one pass: the distances B/2 .. 1 of the block.
//
// That is 25 kernels at E = 2^24 (13 global) and 22 at 2^23.  The schedule
// lives in the wrapper alone (ops/cuda/bitonic_kernel.py, schedule /
// launches), which walks it, chooses each global pass's kind and calls
// vk3d_bitonic_pass once a pass, so each pass can sit in a tracing section;
// this file only maps a pass (its kind, k, lowest distance and group) to its
// kernel.  A block pass (first, merge, wide) holds 32 elements a thread in
// registers, 256 threads a block.  A thread's 32 elements in layout L are the
// block slots whose bits L .. L+4 are its register index and whose other bits
// are its thread id; the stages at distances 2^L .. 2^(L+4) run in registers,
// and the elements are re-mapped through shared memory (three uint32 arrays,
// 12 B a slot, XOR-swizzled so that no layout's warp access has a bank
// conflict) when a stage's distance leaves the layout: a merge runs in
// layouts 8, 3 and 0, a wide pass in 8 and, past five distances, 3; each then
// re-maps to layout 8, whose loads and stores are coalesced.  A re-map walks
// a thread's words in Gray-code order, one XOR a register.
//
// The first pass and the merges fit 128 registers a thread, so two blocks
// share an SM and one's stages overlap the other's re-maps, loads and
// stores.  The first pass runs its 91 stages (23 re-maps) in one loop over
// a table of them, which carries one counter as a merge's loop carries one
// distance: 126 registers, no spill, two blocks an SM, 0.905 ms at 2^24 on
// an H100 (1.216 at one block an SM; PERF.md).  A loop over k and the
// distance spilled at 128.  B = 2^14 (512 threads, one block an SM) led
// while a block ran alone on its SM, and lost once the 2^13 merges ran two
// to an SM.
//
// The wide pass spilled at 128 registers (its 32 addresses have a stride
// known only at run time) and cost 0.18-0.22 ms a pass at 2^24 on an H100,
// against 0.14 for a register pass; at 255 registers, one block an SM, its
// blocks' loads, stages and stores took turns (0.14-0.19 ms).  So it stages
// the next block's slots in shared memory (cp.async) while this block's
// stages run: 0.152-0.168 ms for six to nine distances.  Under six, the
// register pass is faster still (0.138-0.142 against 0.144-0.148), and
// keeps them.  Nine distances a pass beat eight by 0.1 ms a sort at 2^24
// and tie ten; runs of 2^(13-g) slots beat runs of 16 at every g by 0.012
// ms a sort (PERF.md).
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
// reference schedule's 105 passes to 25 at E = 2^24.  The shared passes run
// below the memory rate: a compare-exchange is 14 integer instructions, and
// a re-map moves 24 B a slot through shared memory.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLogBlock = 13;              // B = 2^13 elements a pass's block
constexpr int kPerLog = 5;                 // a pass's thread holds 2^5 elements
constexpr int kPer = 1 << kPerLog;
constexpr int kTop = kLogBlock - kPerLog;  // the coalesced layout
constexpr int kThreads = 1 << kTop;
// A wide pass's most distances: its block's other 13 - g bits are runs of
// consecutive list slots, 16 or more (bitonic_kernel.GROUP).
constexpr int kGroup = 9;
constexpr int kRegisterGroup = 5;  // a register pass's most distances
// The kinds of pass vk3d_bitonic_pass runs (bitonic_kernel.KINDS).
constexpr int kFirst = 0, kRegister = 1, kMerge = 2, kWide = 3;

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

// ---- register passes -------------------------------------------------------

// A global pass of G <= kRegisterGroup distances 2^(lo_bit+G-1) .. 2^lo_bit
// of one k > B: thread `tid` owns the slots base + u * 2^lo_bit, u < 2^G,
// where base is tid with the bits lo_bit .. lo_bit+G-1 cleared.  k lies
// above the group's bits, so the direction is the thread's.
template <int G>
__global__ void __launch_bounds__(kThreads)
bitonic_global_kernel(uint64_t* __restrict__ keys, uint32_t* __restrict__ idx, int64_t threads,
                      int64_t k, int lo_bit) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
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

// ---- passes through a block -------------------------------------------------
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

// The bit in which g and g - 1 differ in Gray code (g > 0).
__host__ __device__ constexpr int gray_step(int g) { return g & 1 ? 0 : 1 + gray_step(g >> 1); }

// Calls f(u, word) for each register u of thread t in layout L: the word is
// swizzle(layout_base(t, L) | u << L).  The two parts share no bit and the
// swizzle is linear over XOR, so the word is swizzle(layout_base) ^
// swizzle(u << L); walking u in Gray-code order, each word is the last one
// XOR one of five, an instruction a register where shifting u by the
// layout took four.
template <typename F>
__device__ __forceinline__ void for_each_word(uint32_t t, int layout, F&& f) {
  uint32_t step[kPerLog];
#pragma unroll
  for (int i = 0; i < kPerLog; ++i) step[i] = swizzle(1u << (layout + i));
  uint32_t q = swizzle(layout_base(t, layout));
#pragma unroll
  for (int g = 0; g < kPer; ++g) {
    if (g) q ^= step[gray_step(g)];
    f(g ^ (g >> 1), q);
  }
}

// Moves the registers from layout `from` to layout `to` through shared
// memory (s: the high words, then the low words, then the indices, B each).
__device__ __forceinline__ void relayout(uint32_t (&hi)[kPer], uint32_t (&lo)[kPer],
                                         uint32_t (&ix)[kPer], uint32_t* s, uint32_t t,
                                         int from, int to) {
  constexpr uint32_t kB = 1u << kLogBlock;
  __syncthreads();  // the previous re-map's reads are done
  for_each_word(t, from, [&](int u, uint32_t q) {
    s[q] = hi[u];
    s[kB + q] = lo[u];
    s[2 * kB + q] = ix[u];
  });
  __syncthreads();
  for_each_word(t, to, [&](int u, uint32_t q) {
    hi[u] = s[q];
    lo[u] = s[kB + q];
    ix[u] = s[2 * kB + q];
  });
}

// Registers, a bit each, whose pair runs descending in a stage of k = 2^lk
// in layout b of block `blk`: slot i = base + (layout_base(t, b) | u << b)
// descends where bit lk of i is set, which is the block index's bit
// lk - kLogBlock for k >= B (a global pass's slot map keeps that too), a
// register bit
// for b <= lk < b+5 (the thread's part is zero there) and the thread's
// otherwise.
__device__ __forceinline__ uint32_t descending(uint32_t t, int b, int lk, uint32_t blk) {
  if (lk >= kLogBlock) return (blk >> (lk - kLogBlock)) & 1u ? ~0u : 0u;
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

// Stage (2^lk, block-slot bit x) of a pass over block `blk`, re-mapping
// first if x is outside the current layout b.
__device__ __forceinline__ void shared_stage(uint32_t (&hi)[kPer], uint32_t (&lo)[kPer],
                                             uint32_t (&ix)[kPer], uint32_t* s, uint32_t t,
                                             int& b, int lk, int x, uint32_t blk) {
  if (x < b || x >= b + kPerLog) {
    const int to = layout_for(x);
    relayout(hi, lo, ix, s, t, b, to);
    b = to;
  }
  const uint32_t desc = descending(t, b, lk, blk);
  switch (x - b) {
    case 0: register_stage<0>(hi, lo, ix, desc); break;
    case 1: register_stage<1>(hi, lo, ix, desc); break;
    case 2: register_stage<2>(hi, lo, ix, desc); break;
    case 3: register_stage<3>(hi, lo, ix, desc); break;
    default: register_stage<4>(hi, lo, ix, desc); break;
  }
}

// The first pass's stages (k = 2^lk, block-slot bit x) in schedule order,
// lk = 1 .. kLogBlock and x = lk-1 .. 0 for each, packed as lk << 4 | x.
constexpr int kFirstCount = kLogBlock * (kLogBlock + 1) / 2;
struct FirstStages {
  uint8_t v[kFirstCount];
};
constexpr FirstStages first_stages() {
  FirstStages s{};
  int n = 0;
  for (int lk = 1; lk <= kLogBlock; ++lk) {
    for (int x = lk - 1; x >= 0; --x) s.v[n++] = static_cast<uint8_t>(lk << 4 | x);
  }
  return s;
}
__constant__ FirstStages kFirstStages = first_stages();

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
__global__ void __launch_bounds__(kThreads, 2)
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
    // One loop over the stages in schedule order, read from kFirstStages:
    // it carries one counter and the layout, as a merge's carries x and
    // the layout (its lk stays a parameter), so it fits 128 registers.
#pragma unroll 1
    for (int s = 0; s < kFirstCount; ++s) {
      const int v = kFirstStages.v[s];
      shared_stage(hi, lo, ix, smem, t, b, v >> 4, v & 15, blockIdx.x);
    }
  } else {
#pragma unroll 1
    for (int x = kLogBlock - 1; x >= 0; --x) {
      shared_stage(hi, lo, ix, smem, t, b, lk, x, blockIdx.x);
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

// ---- wide passes -----------------------------------------------------------
//
// A wide pass runs the G <= kGroup distances 2^(lo_bit+G-1) .. 2^lo_bit of
// k = 2^lk > B over blocks of B slots strided through the list.  Block slot
// p holds list slot wide_slot(p): p's low run = kLogBlock - G bits are its
// low bits, so a warp's copies cover runs of 2^run consecutive slots (16 at
// nine distances: 128 B of keys, 64 B of index); p's top G bits are its bits
// lo_bit .. lo_bit+G-1, the distances; its other bits are the block index's,
// in order.  So each block holds both slots of every pair, and a slot's bit
// lk is its block index's bit lk - kLogBlock, which `descending` reads.
// wide_offset places p's own bits; the block index's fill the rest.
__device__ __forceinline__ int64_t wide_offset(uint32_t p, int lo_bit, int run) {
  return (p & ((1u << run) - 1u)) | (static_cast<int64_t>(p >> run) << lo_bit);
}

__device__ __forceinline__ int64_t wide_slot(uint32_t p, int64_t blk, int lo_bit, int run) {
  const int below = lo_bit - run;  // the block index's bits under the distances
  return wide_offset(p, lo_bit, run) | ((blk & ((int64_t{1} << below) - 1)) << run) |
         ((blk >> below) << (lo_bit + kLogBlock - run));
}

// A 16-byte copy from global to shared memory that no register holds.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const auto d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// Starts the copies of block blk's slots into the staging area (sk: B keys,
// si: B indices, in block-slot order): two keys or four indices a copy, one
// run's neighbours, 24 copies a thread.
__device__ __forceinline__ void stage_block(const uint64_t* keys, const uint32_t* idx,
                                            uint64_t* sk, uint32_t* si, uint32_t t, int64_t blk,
                                            int lo_bit, int run) {
  constexpr uint32_t kB = 1u << kLogBlock;
#pragma unroll
  for (uint32_t j = 0; j < kB / 2 / kThreads; ++j) {
    const uint32_t p = 2 * (t + j * kThreads);
    copy16(sk + p, keys + wide_slot(p, blk, lo_bit, run));
  }
#pragma unroll
  for (uint32_t j = 0; j < kB / 4 / kThreads; ++j) {
    const uint32_t p = 4 * (t + j * kThreads);
    copy16(si + p, idx + wide_slot(p, blk, lo_bit, run));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A wide pass: each resident block takes blocks blockIdx.x, + gridDim.x,
// ... of the list in turn and stages the next one's slots into shared
// memory while this one's stages run and its stores drain, so the pass's
// loads overlap its integer work.  The stages run as a merge's do: those
// at p's bits kTop .. kTop+4 in the coalesced layout, the rest after a
// re-map to layout kTop - 5.  Shared memory: the re-map area (12 B a slot)
// and the staging area (12 B a slot), 192 KB, one block an SM.
__global__ void __launch_bounds__(kThreads, 1)
bitonic_wide_kernel(uint64_t* __restrict__ keys, uint32_t* __restrict__ idx, uint32_t blocks,
                    int lk, int lo_bit, int group) {
  constexpr uint32_t kB = 1u << kLogBlock;
  extern __shared__ __align__(16) uint32_t smem[];
  uint64_t* sk = reinterpret_cast<uint64_t*>(smem + 3 * kB);
  uint32_t* si = smem + 5 * kB;
  const uint32_t t = threadIdx.x;
  const int run = kLogBlock - group;
  uint32_t blk = blockIdx.x;
  if (blk < blocks) stage_block(keys, idx, sk, si, t, blk, lo_bit, run);
  for (; blk < blocks; blk += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this block's slots have landed
    uint32_t hi[kPer], lo[kPer], ix[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const uint32_t p = t | (static_cast<uint32_t>(u) << kTop);
      const uint64_t key = sk[p];
      hi[u] = static_cast<uint32_t>(key >> 32);
      lo[u] = static_cast<uint32_t>(key);
      ix[u] = si[p];
    }
    __syncthreads();  // the staging area is free
    if (blk + gridDim.x < blocks) stage_block(keys, idx, sk, si, t, blk + gridDim.x, lo_bit, run);
    int b = kTop;
#pragma unroll 1
    for (int x = kLogBlock - 1; x >= kLogBlock - group; --x) {
      shared_stage(hi, lo, ix, smem, t, b, lk, x, blk);
    }
    if (b != kTop) relayout(hi, lo, ix, smem, t, b, kTop);
    // Register u holds block slot t | u << kTop, whose bits are t's and u's.
    const int64_t g0 = wide_slot(t, blk, lo_bit, run);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t g = g0 | wide_offset(static_cast<uint32_t>(u) << kTop, lo_bit, run);
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

// A pass of `grid` blocks with `smem` bytes of dynamic shared memory.
// Shared memory above 48 KB needs the kernel's opt-in; a refused opt-in is
// returned, never worked around with a smaller block.
template <typename... Params, typename... Args>
cudaError_t launch_blocks(void (*kernel)(Params...), unsigned int grid, int smem,
                          cudaStream_t s, Args... args) {
  cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <bool kFromCols, bool kToCols>
cudaError_t launch_shared(const Columns& c, uint32_t n, int lk, unsigned int blocks,
                          cudaStream_t s) {
  return launch_blocks(bitonic_shared_kernel<kFromCols, kToCols>, blocks, 12 << kLogBlock, s,
                       c.tile, c.depth, c.index, c.keys, c.idx, c.out_tile, c.out_depth,
                       c.out_index, n, lk);
}

template <int G>
cudaError_t launch_register(const Columns& c, int64_t e, int64_t k, int lo, cudaStream_t s) {
  const int64_t threads = e >> G;
  const auto blocks = static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
  bitonic_global_kernel<G><<<blocks, kThreads, 0, s>>>(c.keys, c.idx, threads, k, lo);
  return cudaGetLastError();
}

// The SMs of `device`, read once a device.
cudaError_t sm_count(int device, unsigned int* sms) {
  static std::atomic<unsigned int> cached[64];
  const bool cacheable = device >= 0 && device < 64;
  if (cacheable && (*sms = cached[device].load(std::memory_order_acquire)) != 0) {
    return cudaSuccess;
  }
  int n = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  *sms = static_cast<unsigned int>(n);
  if (cacheable) cached[device].store(*sms, std::memory_order_release);
  return cudaSuccess;
}

// A wide pass's grid: a block an SM, or one a block of the list.
cudaError_t launch_wide(const Columns& c, unsigned int blocks, int lk, int lo, int g, int device,
                        cudaStream_t s) {
  unsigned int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  return launch_blocks(bitonic_wide_kernel, blocks < sms ? blocks : sms, 24 << kLogBlock, s,
                       c.keys, c.idx, blocks, lk, lo, g);
}

cudaError_t launch_register_pass(const Columns& c, int64_t e, int64_t k, int lo, int g,
                                 cudaStream_t s) {
  switch (g) {
    case 1: return launch_register<1>(c, e, k, lo, s);
    case 2: return launch_register<2>(c, e, k, lo, s);
    case 3: return launch_register<3>(c, e, k, lo, s);
    case 4: return launch_register<4>(c, e, k, lo, s);
    case 5: return launch_register<5>(c, e, k, lo, s);
    default: return cudaErrorInvalidValue;
  }
}

// One pass of the schedule.  The schedule itself, and the choice between a
// register and a wide pass, are the wrapper's (bitonic_kernel.launches);
// this only maps a pass to its kernel.
cudaError_t run_pass(int kind, const Columns& c, int64_t e, int64_t k, int lo, int g, int device,
                     cudaStream_t s) {
  constexpr int64_t kBlock = int64_t{1} << kLogBlock;
  const auto blocks = static_cast<unsigned int>(e >> kLogBlock);
  if (kind == kFirst) {
    if (e <= kBlock) {  // one block: from the columns to the columns
      return launch_shared<true, true>(c, static_cast<uint32_t>(e), 0, 1, s);
    }
    return launch_shared<true, false>(c, kBlock, 0, blocks, s);
  }
  // Global and merge passes run for k = 2B .. e, a power of two.
  if (k < 2 * kBlock || k > e || (k & (k - 1))) return cudaErrorInvalidValue;
  const int lk = __builtin_ctzll(static_cast<unsigned long long>(k));
  if (kind == kRegister || kind == kWide) {
    const int most = kind == kWide ? kGroup : kRegisterGroup;
    if (lo < kLogBlock || g < 1 || g > most || lo + g > lk) return cudaErrorInvalidValue;
    return kind == kWide ? launch_wide(c, blocks, lk, lo, g, device, s)
                         : launch_register_pass(c, e, k, lo, g, s);
  }
  if (kind == kMerge) {
    return k == e ? launch_shared<false, true>(c, kBlock, lk, blocks, s)
                  : launch_shared<false, false>(c, kBlock, lk, blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Runs one pass of the sort of [e] elements (e a power of two) from the
// int64 columns tile, depth, index into out_*: `kind` 0 the first shared
// pass (every k <= B; to out_* when e <= B), 1 a register pass and 3 a wide
// pass (the `group` distances 2^(lo_bit+group-1) .. 2^lo_bit of k, up to 5
// and 9), 2 the merge of k (the distances B/2 .. 1; to out_* when k == e).
// keys ([e] uint64) and idx ([e] uint32) are the scratch the passes hand
// on, used (and may be NULL otherwise) when e > B = 2^13.  A pass outside the network returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int vk3d_bitonic_pass(int32_t kind, const void* tile, const void* depth,
                                 const void* index, int64_t e, void* keys, void* idx,
                                 void* out_tile, void* out_depth, void* out_index, int64_t k,
                                 int32_t lo_bit, int32_t group, int32_t device, void* stream) {
  if (e <= 0 || (e & (e - 1))) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Columns c{static_cast<const int64_t*>(tile), static_cast<const int64_t*>(depth),
                  static_cast<const int64_t*>(index), static_cast<uint64_t*>(keys),
                  static_cast<uint32_t*>(idx), static_cast<int64_t*>(out_tile),
                  static_cast<int64_t*>(out_depth), static_cast<int64_t*>(out_index)};
  return static_cast<int>(
      run_pass(kind, c, e, k, lo_bit, group, device, static_cast<cudaStream_t>(stream)));
}
