// The AUTO sort: a one-sweep LSD radix sort of the sort elements over the
// used key bits.
//
// Not a TPU kernel: it replaces the JAX package's two `jax.lax.sort` calls
// on the sort elements, vk3dgaussiansplatting_tpu/ops/sort.py:37
// sort_elements_xla and parallel/dist.py:195 _sort3 (3 keys, unstable, the
// id as the third key), and takes the GPU shape of the reference's
// RadixSort (RadixSort.cpp:201-653: an LSD radix over the used bits of the
// GPU-side live count) in the one-sweep form of Adinets & Merrill,
// "Onesweep: A Faster Least Significant Digit Radix Sort for GPUs"
// (arXiv:2206.01784).  Its plain version is ops/sort.py:
// sort_elements_radix_plain, the same arithmetic in torch ops.
//
// Key.  tile' = num_tiles where tile is SENTINEL, else tile, above the 32
// depth bits: 32 + bit_length(num_tiles) bits (one more than
// config.num_tile_bits where num_tiles is a power of two: the mapped
// SENTINEL needs it), sorted 8 bits a pass from the least significant: 6
// passes at 720p (44 bits) and 1080p (45).  Every pass is stable, so the
// order is (tile, depth) with ties in slot order; keygen emits a gaussian's
// slots in id order, so that is JAX's (tile, depth, id) order.  Tiles must
// be below num_tiles or SENTINEL, as keygen makes them.
//
// Count bound.  The sort covers slots [0, n), n = min(count, E) read from
// device memory (the host never reads the count).  The setup kernel writes
// SENTINEL into the three outputs of [n, E) (the identity into the
// permutation), as the reference's RadixSortIndirectSetup bounds its
// dispatch by the live count, and checks that each input slot there is a
// SENTINEL triple; if one is not, every later kernel takes n = E.  So the
// result is the stable sort of all E slots on any list, and on keygen's
// lists (live slots a prefix, SENTINEL triples after) only the live prefix
// is sorted.  Without a count (the distributed frame's received lists,
// which hold sentinels between live slots) n = E and there is no setup.
//
// Kernels of a sort: the setup (with a count), one histogram kernel, then
// one scatter kernel a digit: 8 at 720p and 1080p, 7 without a count.
//  (a) histogram: reads the int64 depth and tile of [0, n) once and counts
//      every pass's digits in block-private shared bins, added with atomics
//      into the [passes][256] global table (sums of counts: the same table
//      whatever the order).  It also zeroes every pass's look-back status
//      words (the scratch comes from a caching allocator and holds the last
//      sort's flags).
//  (b) scatter, a digit.  A block takes its partition (6144 slots) from the
//      pass's atomic ticket, never from blockIdx: a partition's
//      predecessors have then all started, so the look-back never waits on
//      a block that is not resident.  Partitions at or past the live prefix
//      take their ticket and exit; no live partition looks back at them.
//      The block
//      1. stages its three record columns in shared memory (cp.async, 16 B
//         at a time, all in flight at once; the first pass converts the
//         int64 columns through registers);
//      2. finds each element's peers in its round (warp w holds slots
//         [512 w, 512 w + 512), 32 a round; __match_any_sync), adds the
//         partition's count of each digit in shared memory and publishes
//         it, bin t by thread t, flagged AGGREGATE (INCLUSIVE for
//         partition 0);
//      3. ranks each element among the equal digits of its warp's earlier
//         slots (per-warp bin counters carried from round to round), then
//         the warps' counts in warp order, and scans the partition's counts
//         over the bins: each element's place in the partition's sorted
//         order, and the inverse map, sorted place -> slot;
//      4. looks back, thread t over bin t: the earlier partitions' words,
//         AGGREGATE counts summed until an INCLUSIVE one, then publishes
//         its INCLUSIVE prefix.  A word is the flag in its top two bits and
//         the count in the low 30, stored and loaded whole
//         (st/ld.relaxed.gpu): a reader never sees a flag without its
//         count, and nothing else is published, so no fence is needed;
//      5. writes the records out in sorted order: sorted place i goes to its
//         bin's base (the exclusive scan of the pass's global bins) + the
//         earlier partitions' count of the bin + (i - the bin's place in the
//         partition), so each bin's run of a partition lands contiguously.
// Records ping-pong between two scratch buffers as three uint32 columns
// (depth, tile', payload: the id, or the slot when the permutation is
// asked for), each padded to a multiple of 4 words.  The first scatter
// reads the int64 columns; the last writes the int64 tile, depth and index
// (the index gathered by slot when the permutation is asked for) and the
// int64 permutation.  The tickets decide only which block takes which
// partition, never an order: the result is deterministic and stable.
//
// What bounds it on the H100: bytes.  The function reads 24 B a live slot
// and writes 24 B a slot: 0.66 GB at garden (13.1M live of 14.19M), 0.20
// ms at 3.35 TB/s.  A radix sort must move each record once a pass: the
// histogram reads 16 B a slot once, and the scatters read and write 12 B a
// slot (the first reads 24 B, the last writes 24 B), ~184 B a sorted slot
// over 6 passes, plus the status words (passes x partitions x 1 KB zeroed,
// then written and read).  What the design does about it: it sorts only the
// used key bits and the live prefix, carries 12-byte records instead of a
// 64-bit key and a permutation, reads the key columns once for all the
// digits' histograms, launches one kernel a digit, and holds two 89 KB
// blocks an SM (24 warps), so one block's ranking and look-back overlap the
// other's copies.
//
// Built with -DVK3D_RADIX_PHASES=1 (chip_smoke.radix_phases), the scatter
// also stamps each partition's phases (thread 0's clock after steps 1-5
// above) and the length of bin 0's look-back, read with vk3d_radix_phases;
// the library the port loads is built without it.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // elements a thread
constexpr int kTile = kThreads * kItems;   // 6144 slots a partition
constexpr int kWarpSlots = 32 * kItems;    // 512 slots a warp
constexpr int kFirstBatch = 4;             // rounds of int64 loads in flight (first pass)
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr uint32_t kDigitMask = (2u << kDigitBits) - 1u;  // a digit, or kBins for no slot
constexpr int kMaxPasses = 8;              // 32 + 31 key bits
// The scratch's header: the setup's flag, a ticket a pass, and the
// [kMaxPasses][kBins] global digit table (16 B aligned after it).
constexpr int kTicketWord = 1;
constexpr int kHistWord = 16;
constexpr int kHeaderWords = kHistWord + kMaxPasses * kBins;
constexpr int kHistThreads = 256;
constexpr int kHistItems = 4;              // slots a thread a round
constexpr int kHistBlocks = 1056;          // 8 an SM, grid-striding
constexpr int kSetupBlocks = 1056;
constexpr int kStatusCountBits = 30;       // slots below 2^30
constexpr uint32_t kAggregate = 1u << kStatusCountBits;
constexpr uint32_t kInclusive = 2u << kStatusCountBits;
constexpr uint32_t kCountMask = kAggregate - 1u;
constexpr int64_t kSentinel = 0xFFFFFFFFll;  // core/config.py SENTINEL
constexpr unsigned kFull = 0xFFFFFFFFu;
// The scatter's dynamic shared memory: the partition's three record
// columns, the per-warp bin counters (later the inverse map), the
// partition's bin counts, the local and global bin offsets, the scan sums.
constexpr int kScatterSmem = (3 * kTile + kWarps * kBins + 3 * kBins + 32) * 4;

static_assert(kThreads >= kBins && kThreads % 32 == 0, "a thread a bin in the per-bin steps");
static_assert(kTile <= 0x10000 && kTile % 4 == 0, "places pack two to a register; whole vectors");
static_assert(kItems % kFirstBatch == 0, "whole batches");
static_assert(kDigitBits + 1 + 5 + 6 <= 32, "a digit, the lanes below and its peers in one word");
static_assert(kWarps * kBins * 4 >= kTile * 2, "the inverse map fits over the warp counters");
static_assert(kHeaderWords % 4 == 0, "the status words start 16 B aligned");
static_assert(2 * (kScatterSmem + 1024) <= 228 * 1024, "two scatter blocks an SM");

#if VK3D_RADIX_PHASES
constexpr int kPhaseParts = 4096;  // partitions stamped a pass
constexpr int kPhaseSlots = 10;
__device__ unsigned long long g_phases[kMaxPasses][kPhaseParts][kPhaseSlots];
#define RADIX_PHASE(k, v) \
  if (tid == 0 && part < kPhaseParts) g_phases[p.pass][part][k] = (v)
#define RADIX_PHASE_SYNC() __syncthreads()
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
#define RADIX_PHASE(k, v) ((void)0)
#define RADIX_PHASE_SYNC() ((void)0)
#endif

// The sorted prefix's length: min(count, e), or e without a count or when
// the setup found a slot past the count that is not a SENTINEL triple.
__device__ __forceinline__ uint32_t sorted_len(const int64_t* count, const uint32_t* flag,
                                               uint32_t e) {
  if (count == nullptr || *flag != 0) return e;
  const int64_t c = *count;
  return c <= 0 ? 0u : (c >= static_cast<int64_t>(e) ? e : static_cast<uint32_t>(c));
}

__device__ __forceinline__ void store_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t load_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(uint32_t* smem, const uint32_t* gmem) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive scan of v over the block's threads (a multiple of 32).  `sums`
// is 32 words of shared memory; every thread of the block must call it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t inc = warp_inclusive(v);
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) sums[lane] = warp_inclusive(lane < nwarps ? sums[lane] : 0u);
  __syncthreads();
  const uint32_t out = inc - v + (warp > 0 ? sums[warp - 1] : 0u);
  __syncthreads();  // sums may be reused
  return out;
}

// The tail [min(count, e), e): SENTINEL into the outputs, the identity into
// the permutation, and the flag set if an input slot there is not a
// SENTINEL triple.
__global__ void __launch_bounds__(kHistThreads) radix_setup_kernel(
    const int64_t* __restrict__ tile, const int64_t* __restrict__ depth,
    const int64_t* __restrict__ index, const int64_t* __restrict__ count, uint32_t e,
    uint32_t* __restrict__ flag, int64_t* __restrict__ out_tile, int64_t* __restrict__ out_depth,
    int64_t* __restrict__ out_index, int64_t* __restrict__ out_perm) {
  const int64_t c = *count;
  const uint32_t n = c <= 0 ? 0u : (c >= static_cast<int64_t>(e) ? e : static_cast<uint32_t>(c));
  bool bad = false;
  for (uint32_t i = n + blockIdx.x * kHistThreads + threadIdx.x; i < e;
       i += gridDim.x * kHistThreads) {
    bad |= tile[i] != kSentinel || depth[i] != kSentinel || index[i] != kSentinel;
    out_tile[i] = kSentinel;
    out_depth[i] = kSentinel;
    out_index[i] = kSentinel;
    if (out_perm != nullptr) out_perm[i] = i;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1u;
}

// (a) Every pass's digit counts of [0, n) into hist[passes][kBins], and the
// status words zeroed.
__global__ void __launch_bounds__(kHistThreads) radix_histogram_kernel(
    const int64_t* __restrict__ tile, const int64_t* __restrict__ depth,
    const int64_t* __restrict__ count, const uint32_t* __restrict__ flag, uint32_t e,
    uint32_t num_tiles, int passes, uint32_t* __restrict__ hist, uint4* __restrict__ status,
    size_t status_vecs) {
  __shared__ uint32_t bins[kMaxPasses * kBins];
  for (int k = threadIdx.x; k < passes * kBins; k += kHistThreads) bins[k] = 0;
  const size_t stride = static_cast<size_t>(gridDim.x) * kHistThreads;
  for (size_t k = static_cast<size_t>(blockIdx.x) * kHistThreads + threadIdx.x; k < status_vecs;
       k += stride) {
    status[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const uint32_t n = sorted_len(count, flag, e);
  // kHistItems slots a thread a round, all loaded before any is counted.
  constexpr uint32_t kRound = kHistThreads * kHistItems;
  for (uint32_t base = blockIdx.x * kRound; base < n; base += gridDim.x * kRound) {
    uint32_t d[kHistItems], t[kHistItems];
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const uint32_t i = base + k * kHistThreads + threadIdx.x;
      d[k] = t[k] = 0;
      if (i < n) {
        const int64_t t64 = __ldcs(reinterpret_cast<const long long*>(tile) + i);
        d[k] = static_cast<uint32_t>(__ldcs(reinterpret_cast<const long long*>(depth) + i));
        t[k] = t64 == kSentinel ? num_tiles : static_cast<uint32_t>(t64);
      }
    }
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      if (base + k * kHistThreads + threadIdx.x < n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          atomicAdd(&bins[q * kBins + ((d[k] >> (kDigitBits * q)) & (kBins - 1))], 1u);
        }
        for (int q = 4; q < passes; ++q) {
          atomicAdd(&bins[q * kBins + ((t[k] >> (kDigitBits * (q - 4))) & (kBins - 1))], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < passes * kBins; k += kHistThreads) {
    if (bins[k] != 0) atomicAdd(&hist[k], bins[k]);
  }
}

struct Pass {
  const int64_t* tile64;   // the int64 input columns (first pass; index64
  const int64_t* depth64;  // also the last pass's gather by slot)
  const int64_t* index64;
  const uint32_t* in;      // [3][stride] depth, tile', payload (later passes)
  uint32_t* out;           // [3][stride] (all passes but the last)
  int64_t* out_tile;       // the int64 outputs (last pass)
  int64_t* out_depth;
  int64_t* out_index;
  int64_t* out_perm;       // NULL: no permutation; the payload is the id
  const uint32_t* hist;    // this pass's [kBins] digit counts
  uint32_t* status;        // this pass's [partitions][kBins] look-back words
  uint32_t* ticket;        // this pass's partition ticket
  const int64_t* count;
  const uint32_t* flag;
  uint32_t e;
  uint32_t stride;         // words between the record columns: e rounded up to 4
  uint32_t num_tiles;
  int column;              // 0: the digit is in depth, 1: in tile'
  int shift;
  int pass;
};

// (b) One digit's chained-scan scatter of one partition (steps 1-5 at the
// top of the file).
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads, 2) radix_scatter_kernel(const Pass p) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t s_part;
  uint32_t* s_col = smem;                         // [3][kTile] depth, tile', payload
  uint32_t* whist = smem + 3 * kTile;             // [kWarps][kBins]
  uint32_t* bcount = whist + kWarps * kBins;      // [kBins] the partition's counts
  uint32_t* local_off = bcount + kBins;           // [kBins]
  uint32_t* gdelta = local_off + kBins;           // [kBins] global - local place
  uint32_t* sums = gdelta + kBins;                // [32]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_part = atomicAdd(p.ticket, 1u);
  for (int i = tid; i < (kWarps + 1) * kBins; i += kThreads) whist[i] = 0;
  __syncthreads();
  const uint32_t part = s_part;
  const uint32_t n = sorted_len(p.count, p.flag, p.e);
  const uint32_t start = part * kTile;
  if (start >= n) return;  // uniform over the block
  const uint32_t cnt = min(n - start, static_cast<uint32_t>(kTile));
  RADIX_PHASE(0, global_ns());
  RADIX_PHASE(1, clock64());

  // 1. Lane l of warp w holds the partition's slots 512 w + 32 j + l,
  // j < 16; an invalid slot carries the digit kBins.
  const uint32_t wbase = warp * kWarpSlots + lane;
  uint32_t dr[kItems];
  if (kFirst) {
#pragma unroll
    for (int jb = 0; jb < kItems; jb += kFirstBatch) {
      long long tv[kFirstBatch], dv[kFirstBatch], iv[kFirstBatch];
#pragma unroll
      for (int b = 0; b < kFirstBatch; ++b) {
        const uint32_t i = wbase + 32 * (jb + b);
        if (i < cnt) {
          tv[b] = __ldcs(reinterpret_cast<const long long*>(p.tile64) + start + i);
          dv[b] = __ldcs(reinterpret_cast<const long long*>(p.depth64) + start + i);
          iv[b] = p.out_perm != nullptr
                      ? start + i
                      : __ldcs(reinterpret_cast<const long long*>(p.index64) + start + i);
        }
      }
#pragma unroll
      for (int b = 0; b < kFirstBatch; ++b) {
        const uint32_t i = wbase + 32 * (jb + b);
        dr[jb + b] = kBins;
        if (i < cnt) {
          const auto dk = static_cast<uint32_t>(dv[b]);
          s_col[i] = dk;
          s_col[kTile + i] = tv[b] == kSentinel ? p.num_tiles : static_cast<uint32_t>(tv[b]);
          s_col[2 * kTile + i] = static_cast<uint32_t>(iv[b]);
          dr[jb + b] = (dk >> p.shift) & (kBins - 1);  // the first digit is depth's
        }
      }
    }
  } else {
    // The padded columns keep each segment 16 B aligned and its last
    // vector inside the column.
    const uint32_t vecs = (cnt + 3) / 4;
    for (uint32_t v = tid; v < 3 * vecs; v += kThreads) {
      const uint32_t c = v / vecs;
      const uint32_t w = 4 * (v - c * vecs);
      cp_async16(s_col + c * kTile + w, p.in + c * static_cast<size_t>(p.stride) + start + w);
    }
    cp_async_wait_all();
    __syncthreads();
    const uint32_t* dcol = s_col + p.column * kTile;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t i = wbase + 32 * j;
      dr[j] = i < cnt ? (dcol[i] >> p.shift) & (kBins - 1) : kBins;
    }
  }
  RADIX_PHASE_SYNC();
  RADIX_PHASE(2, clock64());

  // 2. The peers of each element; the round's lowest peer adds their number
  // to the partition's count of the digit.  The lanes below and the peers'
  // number are kept beside the digit (9 + 5 + 6 bits).
  const uint32_t below_mask = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = dr[j];
    const uint32_t peers = __match_any_sync(kFull, d);
    const uint32_t below = __popc(peers & below_mask);
    if (d < kBins && below == 0) atomicAdd(&bcount[d], __popc(peers));
    dr[j] = d | (below << (kDigitBits + 1)) | (__popc(peers) << (kDigitBits + 6));
  }
  __syncthreads();
  const bool bin_thread = tid < kBins;
  uint32_t run = 0;
  if (bin_thread) {
    run = bcount[tid];
    store_status(p.status + static_cast<size_t>(part) * kBins + tid,
                 (part == 0 ? kInclusive : kAggregate) | run);
  }

  // 3. The rank among the equal digits of the warp's earlier slots replaces
  // the lanes below; then per bin the warps' counts become their offsets in
  // warp order, and the bins' local offsets and global bases are scanned.
  uint32_t* wh = whist + warp * kBins;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t d = dr[j] & kDigitMask;
    const uint32_t below = (dr[j] >> (kDigitBits + 1)) & 31u;
    const bool valid = d < kBins;
    const uint32_t base = valid ? wh[d] : 0u;
    __syncwarp();
    if (valid && below == 0) wh[d] = base + (dr[j] >> (kDigitBits + 6));
    __syncwarp();
    dr[j] = ((base + below) << (kDigitBits + 1)) | d;
  }
  __syncthreads();
  RADIX_PHASE(3, clock64());
  if (bin_thread) {
    uint32_t offset = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = whist[w * kBins + tid];
      whist[w * kBins + tid] = offset;
      offset += c;
    }
  }
  const uint32_t lo = block_exclusive_scan(bin_thread ? run : 0u, sums);
  const uint32_t gbase = block_exclusive_scan(bin_thread ? p.hist[tid] : 0u, sums);
  if (bin_thread) local_off[tid] = lo;
  __syncthreads();
  RADIX_PHASE(4, clock64());
  // Each element's place in the partition's sorted order, two to a
  // register; then the inverse map as uint16 over the warp counters, which
  // are read until the barrier.
  uint32_t pos[kItems / 2];
#pragma unroll
  for (int j = 0; j < kItems; j += 2) {
    uint32_t two = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t d = dr[j + h] & kDigitMask;
      if (d < kBins) two |= (local_off[d] + wh[d] + (dr[j + h] >> (kDigitBits + 1))) << (16 * h);
    }
    pos[j / 2] = two;
  }
  __syncthreads();
  auto* inv = reinterpret_cast<uint16_t*>(whist);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t i = wbase + 32 * j;
    if (i < cnt) inv[(pos[j / 2] >> (16 * (j % 2))) & 0xFFFFu] = static_cast<uint16_t>(i);
  }
  RADIX_PHASE(5, clock64());

  // 4. The look-back, placed after the partition's own work so that its
  // predecessors have had the longest time to publish.  Partition 0 is
  // INCLUSIVE from the start, so the walk ends there at the latest.
  if (bin_thread) {
    uint32_t excl = 0;
    if (part > 0) {
#if VK3D_RADIX_PHASES
      unsigned long long steps = 0;
#endif
      for (uint32_t k = part - 1;; --k) {
        const uint32_t* w = p.status + static_cast<size_t>(k) * kBins + tid;
        uint32_t s;
        do {
          s = load_status(w);
        } while (s < kAggregate);
#if VK3D_RADIX_PHASES
        ++steps;
#endif
        excl += s & kCountMask;
        if (s >= kInclusive) break;
      }
      store_status(p.status + static_cast<size_t>(part) * kBins + tid, kInclusive | (excl + run));
      RADIX_PHASE(9, steps);
    }
    gdelta[tid] = gbase + excl - lo;
  }
  RADIX_PHASE(6, clock64());
  __syncthreads();

  // 5. Thread t writes sorted places t, t + kThreads, ... of all three
  // columns, reading each record where step 1 staged it.
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const uint32_t i = j * kThreads + tid;
    if (i < cnt) {
      const uint32_t src = inv[i];
      const uint32_t dk = s_col[src];
      const uint32_t tk = s_col[kTile + src];
      const uint32_t pk = s_col[2 * kTile + src];
      const uint32_t g = gdelta[((p.column == 0 ? dk : tk) >> p.shift) & (kBins - 1)] + i;
      if (kLast) {
        auto* out_tile = reinterpret_cast<long long*>(p.out_tile);
        auto* out_depth = reinterpret_cast<long long*>(p.out_depth);
        auto* out_index = reinterpret_cast<long long*>(p.out_index);
        __stcs(out_depth + g, static_cast<long long>(dk));
        __stcs(out_tile + g, tk == p.num_tiles ? kSentinel : static_cast<long long>(tk));
        if (p.out_perm != nullptr) {
          __stcs(out_index + g, __ldg(reinterpret_cast<const long long*>(p.index64) + pk));
          __stcs(reinterpret_cast<long long*>(p.out_perm) + g, static_cast<long long>(pk));
        } else {
          __stcs(out_index + g, static_cast<long long>(pk));
        }
      } else {
        __stcs(p.out + g, dk);
        __stcs(p.out + p.stride + g, tk);
        __stcs(p.out + 2 * static_cast<size_t>(p.stride) + g, pk);
      }
    }
  }
  RADIX_PHASE_SYNC();
  RADIX_PHASE(7, clock64());
  RADIX_PHASE(8, global_ns());
}

template <bool kFirst, bool kLast>
cudaError_t launch_scatter(const Pass& p, unsigned int blocks, int device, cudaStream_t s) {
  // Above 48 KB of shared memory needs the kernel's opt-in, a host call
  // made once a device per process (a bit of `opted` each, devices from 64
  // on every time); a refused opt-in is returned and asked again next call.
  // The carveout asks for the most shared memory, so two blocks fit an SM.
  static std::atomic<uint64_t> opted{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit == 0 || !(opted.load(std::memory_order_acquire) & bit)) {
    cudaError_t err = cudaFuncSetAttribute(radix_scatter_kernel<kFirst, kLast>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kScatterSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(radix_scatter_kernel<kFirst, kLast>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_release);
  }
  radix_scatter_kernel<kFirst, kLast><<<blocks, kThreads, kScatterSmem, s>>>(p);
  return cudaGetLastError();
}

int bit_length(int64_t x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}

}  // namespace

// The kernel's compile-time constants, for the wrapper's copies
// (radix_kernel.check_kernel_config): threads a scatter block, elements a
// thread, digit bits, the most passes, the header's words, the status
// words' count bits.  Writes min(n, 6) of them; returns 6.
extern "C" int vk3d_radix_config(int32_t* out, int32_t n) {
  const int32_t v[] = {kThreads, kItems, kDigitBits, kMaxPasses, kHeaderWords, kStatusCountBits};
  for (int i = 0; i < n && i < 6; ++i) out[i] = v[i];
  return 6;
}

#if VK3D_RADIX_PHASES
// The last sort's phase stamps, [kMaxPasses][4096][10] uint64, into `out`
// (host memory): per pass and partition the global ns at the start,
// thread 0's clock at the start, after steps 1 and 2-3, after the scans,
// after the inverse map and after its look-back, at the end, the global ns
// at the end, and bin 0's look-back length in words.
extern "C" int vk3d_radix_phases(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)));
}
#endif

// Sorts the [e] int64 columns tile, depth, index (uint32 values; tiles below
// num_tiles or SENTINEL) by (tile, depth), stably, into out_tile, out_depth,
// out_index, and the slot permutation into out_perm unless it is NULL.
// count: a [] int64 on the device bounding the sorted prefix, or NULL for
// every slot.  e < 2^30 (the status words' counts).  scratch:
// radix_kernel.scratch_words(e, num_tiles) uint32 words, 16 B aligned (the
// header, the [passes][partitions][256] status words, two [3][e rounded up
// to 4] record buffers).  *launches receives the number of kernels
// launched.
extern "C" int vk3d_radix_sort(const void* tile, const void* depth, const void* index,
                               const void* count, int64_t e, int64_t num_tiles, void* scratch,
                               void* out_tile, void* out_depth, void* out_index, void* out_perm,
                               int64_t* launches, int32_t device, void* stream) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e < 0 || e >= (int64_t{1} << kStatusCountBits) || num_tiles <= 0 ||
      num_tiles >= (int64_t{1} << 31) || reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ne = static_cast<uint32_t>(e);
  const uint32_t nparts = (ne + kTile - 1) / kTile;
  const int passes = (32 + bit_length(num_tiles) + kDigitBits - 1) / kDigitBits;
  uint32_t* header = static_cast<uint32_t*>(scratch);
  uint32_t* flag = header;
  uint32_t* tickets = header + kTicketWord;
  uint32_t* hist = header + kHistWord;
  uint32_t* status = header + kHeaderWords;
  const size_t status_words = static_cast<size_t>(passes) * nparts * kBins;
  const uint32_t stride = (ne + 3) & ~3u;
  uint32_t* a = status + status_words;
  uint32_t* b = a + 3 * static_cast<size_t>(stride);

  Pass p{};
  p.tile64 = static_cast<const int64_t*>(tile);
  p.depth64 = static_cast<const int64_t*>(depth);
  p.index64 = static_cast<const int64_t*>(index);
  p.out_tile = static_cast<int64_t*>(out_tile);
  p.out_depth = static_cast<int64_t*>(out_depth);
  p.out_index = static_cast<int64_t*>(out_index);
  p.out_perm = static_cast<int64_t*>(out_perm);
  p.count = static_cast<const int64_t*>(count);
  p.flag = flag;
  p.e = ne;
  p.stride = stride;
  p.num_tiles = static_cast<uint32_t>(num_tiles);

  // The flag, the tickets and the global digit table start at zero.
  if ((err = cudaMemsetAsync(header, 0, kHeaderWords * sizeof(uint32_t), s)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (count != nullptr) {
    const uint32_t tail_blocks = (ne + kHistThreads - 1) / kHistThreads;
    const uint32_t setup_blocks = tail_blocks < kSetupBlocks ? tail_blocks : kSetupBlocks;
    radix_setup_kernel<<<setup_blocks, kHistThreads, 0, s>>>(
        p.tile64, p.depth64, p.index64, p.count, ne, flag, p.out_tile, p.out_depth, p.out_index,
        p.out_perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  const uint32_t hist_need = (ne + kHistThreads * kHistItems - 1) / (kHistThreads * kHistItems);
  radix_histogram_kernel<<<hist_need < kHistBlocks ? hist_need : kHistBlocks, kHistThreads, 0,
                           s>>>(p.tile64, p.depth64, p.count, flag, ne, p.num_tiles, passes, hist,
                                reinterpret_cast<uint4*>(status), status_words / 4);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launches;

  // Pass q reads what pass q - 1 wrote: even passes write a, odd ones b.
  for (int q = 0; q < passes; ++q) {
    const bool first = q == 0;
    const bool last = q == passes - 1;
    p.in = q % 2 == 1 ? a : b;
    p.out = q % 2 == 0 ? a : b;
    p.hist = hist + q * kBins;
    p.status = status + static_cast<size_t>(q) * nparts * kBins;
    p.ticket = tickets + q;
    p.column = q < 4 ? 0 : 1;
    p.shift = kDigitBits * (q < 4 ? q : q - 4);
    p.pass = q;
    err = first ? launch_scatter<true, false>(p, nparts, device, s)
                : (last ? launch_scatter<false, true>(p, nparts, device, s)
                        : launch_scatter<false, false>(p, nparts, device, s));
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return static_cast<int>(cudaSuccess);
}
