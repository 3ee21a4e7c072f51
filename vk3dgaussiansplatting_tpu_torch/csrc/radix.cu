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
// Keys.  tile' = num_tiles where tile is SENTINEL, else tile.  The full key
// (kKeyTileDepth) is tile' above the 32 depth bits: 32 +
// bit_length(num_tiles) bits (one more than config.num_tile_bits where
// num_tiles is a power of two: the mapped SENTINEL needs it), sorted 8 bits
// a pass from the least significant: 6 passes at 720p (44 bits) and 1080p
// (45), 7 at a native 5187 x 3361 frame's 68,575 tiles (49).  Every pass is stable, so the order is (tile, depth) with ties in
// slot order; keygen emits a gaussian's slots in id order, so that is JAX's
// (tile, depth, id) order.  The tile key (kKeyTile) is tile' alone,
// bit_length(num_tiles) bits: 2 passes at 720p and 1080p, 3 at 68,575
// tiles (17 bits); on a list whose
// slots are already in (depth, id) order (keygen's expansion of the rows in
// depth order, below) its stable order is (tile, depth, id) too.  Tiles
// must be below num_tiles or SENTINEL, as keygen makes them.
//
// Records.  With the depth column (the full key; the tile key where the
// caller reads the sorted depth) a record is three uint32 columns: depth,
// tile', payload.  Without it (depth == NULL: the tile key on the uncapped
// frame, whose ranges read the tile and whose blend reads the index) a
// record is two: tile', payload.  The scatter takes the column count as a
// template argument (kCols); ranking, look-back and pipelining are the same.
//
// The rows' depth order (vk3d_radix_depth_order).  keygen's rows (K7's
// [6, N] int32 columns: id, offset, max(w, 1), min_x, min_y, depth bits, and
// its inclusive scan `cum` of the counts) are put in the stable order of
// their 32-bit depth keys, so that K1 expands them into a list already in
// (depth, id) order and the element sort keys only the tile.  A row keeps
// min(cum, E) - min(cum - count, E) slots (K7's index-order truncation at
// the capacity E, InitSortList.comp:143); rows that keep none are dropped.
// The record is three words: the depth key, the row id, and min_x, min_y,
// max(w, 1) and h = kept / max(w, 1) packed (bx, by, bx and the rest of the
// bits, bx = bit_length(grid_w), by = bit_length(grid_h); h all ones marks
// a row whose kept count is not max(w, 1) h, the one that straddles E, or
// whose h does not fit below the marker, and the last pass reads its count
// from `cum`).  The grid needs 2 bx + by <= 31, a bit at least for h.  Up
// to 4K UHD's 240 x 135 tiles the rest holds every h; on wider grids it
// is narrower than the height (6 bits at a native 5187 x 3361 frame's
// 325 x 211, 5 at 8K UHD's 480 x 270), and only the rarer tall rows are
// marked.  Kernels:
//  (c) prep, persistent blocks (two an SM) taking partitions of 4096 rows
//      by ticket: each row's kept count and record, the kept rows compacted
//      in id order (a scan of the keep flags with a decoupled look-back over
//      one status word a partition, read 32 at a time by a warp), the depth
//      key's four digit counts of the kept rows, the number of kept rows m;
//      it zeroes the passes' and (e)'s status words;
//  (b) the scatter above over the m records, four 8-bit digits of the depth
//      key; the last pass writes the rows in depth order as K1 reads them,
//      [6, N] int32 (id, kept count, max(w, 1), min_x, min_y, depth bits);
//  (e) scan, blocks and partitions as (c)'s: the kept counts' inclusive
//      scan in depth order into the int64 `cum` K1 reads, and their
//      exclusive scan over the kept counts (the offset column), with the
//      same look-back; rows at and past m keep 0 slots.
// So K1 expands exactly the index-order expansion's slots, each gaussian's
// first kept tiles in row-major order, in (depth, id) order, with the same
// count min(total, E).
//
// Count bound.  The sort covers slots [0, n), n = min(count, E) read from
// device memory (the host never reads the count).  The setup kernel writes
// SENTINEL into the outputs of [n, E) (the identity into the permutation),
// as the reference's RadixSortIndirectSetup bounds its dispatch by the live
// count, and checks that each input slot there is a SENTINEL in every
// column the sort carries; if one is not, every later kernel takes n = E.
// (Without the depth column a slot whose depth alone is not SENTINEL keeps
// n = count: its tile' sorts last either way, so tile and index come out
// as the three-column sort's.)  So the
// result is the stable sort of all E slots on any list, and on keygen's
// lists (live slots a prefix, SENTINEL triples after) only the live prefix
// is sorted.  Without a count (the distributed frame's received lists,
// which hold sentinels between live slots) n = E and there is no setup.
//
// Kernels of a sort: the setup (with a count), one histogram kernel, then
// one scatter kernel a digit: 8 at 720p and 1080p with the full key, 7
// without a count, 4 with the tile key (5 at 68,575 tiles).
//  (a) histogram: reads the int64 depth (the full key only) and tile of
//      [0, n) once and counts every pass's digits in block-private shared
//      bins, added with atomics
//      into the [passes][256] global table (sums of counts: the same table
//      whatever the order).  It also zeroes every pass's look-back status
//      words (the scratch comes from a caching allocator and holds the last
//      sort's flags).
//  (b) scatter, a digit: a persistent grid, the SMs times the blocks an SM
//      that the kernel's occupancy allows (one 512-thread block with two
//      96 KiB record buffers, 64 KiB with two columns; at most the pass's
//      partitions).  A block takes
//      partitions (8192 slots) from the pass's atomic ticket, never from
//      blockIdx, in increasing order, until a ticket passes the live
//      prefix, and works on them as a software pipeline: while it ranks,
//      looks back and stores its current partition, the next one's records
//      stage into its other buffer, and the next one is counted and
//      published before the current one looks back.  A partition
//      1. is staged: its record columns copied to shared memory, all in
//         flight at once (later passes: one bulk copy a column by thread
//         0, the digit's column counted on one mbarrier of the buffer and
//         the others on a second, so that step 2 waits for the digit's
//         column alone; the first pass: cp.async of the int64
//         columns' low words, the uint32 values, 4 B at a time);
//      2. is counted: each element's peers in its round (warp w holds slots
//         [512 w, 512 w + 512), 32 a round; __match_any_sync), the
//         partition's count of each digit in shared memory, published bin
//         t by thread t, flagged AGGREGATE (INCLUSIVE for partition 0);
//      3. is ranked: each element among the equal digits of its warp's
//         earlier slots (per-warp bin counters carried from round to
//         round), then the warps' counts in warp order, and the partition's
//         counts scanned over the bins: each element's place in the
//         partition's sorted order, and the inverse map, sorted place ->
//         slot;
//      4. looks back, thread t over bin t: the earlier partitions' words,
//         kLookBack in flight at once, AGGREGATE counts summed from the
//         nearest until an INCLUSIVE one, then publishes its INCLUSIVE
//         prefix.  A word is the flag in its top two bits and the count in
//         the low 30, stored and loaded whole (st/ld.relaxed.gpu): a reader
//         never sees a flag without its count, and nothing else is
//         published, so no fence is needed;
//      5. writes the records out in sorted order: sorted place i goes to its
//         bin's base (the exclusive scan of the pass's global bins) + the
//         earlier partitions' count of the bin + (i - the bin's place in the
//         partition), so each bin's run of a partition lands contiguously.
//      A block's loop over its current partition c: take the next ticket
//      (its round trip under c's ranking); rank c; stage the next
//      partition; scan c and build its inverse map; wait for the next
//      partition's stage, count it and publish its AGGREGATE; look back for
//      c; store c.  Its first partition is staged and counted before the
//      loop.  Progress under any schedule: a block publishes a partition's
//      AGGREGATE before it looks back for it, and takes its tickets and
//      finishes its partitions in ticket order.  Let m be the lowest
//      unfinished partition.  Were m the partition a block holds next,
//      that block's current partition would be lower than m and
//      unfinished, which cannot be; so m is its block's current partition,
//      every earlier partition is INCLUSIVE, and m's look-back ends.  A
//      ticket is only ever held by a running block, so no look-back waits
//      on a block that is not resident.  Counting the next partition before
//      the look-back keeps a ticket's AGGREGATE from lagging the block's
//      current partition: a later partition's look-back seldom waits on it.
// Records ping-pong between two scratch buffers as three uint32 columns
// (depth, tile', payload: the id, or the slot when the permutation is
// asked for; for the rows depth, the packed word, the row id), or two
// (tile', payload), each padded to a multiple of 4 words.  The first
// scatter of a sort reads the int64 columns (maps the SENTINEL tile to
// num_tiles, as it counts a tile digit and as it stores, and makes the slot
// payload); the last writes the int64 tile, depth (with three columns) and
// index (the index gathered by slot when the permutation is asked for) and
// the int64 permutation, or the rows' six int32 columns.
// The rows' first scatter reads the prep's records like a middle pass.  The
// tickets decide only which block takes which partition, never an order:
// the result is deterministic and stable.
//
// What bounds it on the H100: bytes.  The function reads 24 B a live slot
// and writes 24 B a slot (16 and 16 with two columns): 0.66 GB at garden
// (13.1M live of 14.19M), 0.20 ms at 3.35 TB/s.  A radix sort must move
// each record once a pass: the histogram reads 16 B a slot once (8 B on
// the tile key), and the scatters read and write 12 B a slot (the first
// reads 24 B, the last writes 24 B), ~184 B a sorted slot over 6 passes,
// 72 B over the tile key's 2 and 48 B with two columns (8 B, 16 B, 16 B),
// plus the status words (passes x partitions x 1 KB zeroed, then written
// and read).  What the design does about it: it sorts only the
// used key bits and the live prefix, carries 12-byte records instead of a
// 64-bit key and a permutation, reads the key columns once for all the
// digits' histograms, launches one kernel a digit, and keeps each block's
// copies off its critical path: a partition's records land while the block
// works on the one before, so the SM has loads in flight through the
// ranking, the scans and the look-back, and a persistent grid has no ragged
// last wave.
//
// Built with -DVK3D_RADIX_PHASES=1 (chip_smoke.radix_phases), the scatter
// also stamps each partition's phases (thread 0's clock after each step of
// the loop above), the length of bin 0's look-back, its block, whether it
// was staged ahead (its copy issued before the block's previous partition
// ended) and how long its block waited for its stage, read with
// vk3d_radix_phases; the library the port loads is built without it.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // elements a thread
constexpr int kTile = kThreads * kItems;   // 8192 slots a partition
constexpr int kWarpSlots = 32 * kItems;    // 512 slots a warp
constexpr int kScatterBlocksPerSm = 1;
constexpr int kLookBack = 8;               // look-back words a bin reads at once
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr uint32_t kDigitMask = (2u << kDigitBits) - 1u;  // a digit, or kBins for no slot
constexpr int kMaxPasses = 8;              // 32 + 31 key bits
constexpr int kKeyTileDepth = 0;           // vk3d_radix_sort's keys
constexpr int kKeyTile = 1;
constexpr int kDepthPasses = 4;            // the rows' 32-bit depth key
constexpr int kRowThreads = 512;           // the rows' prep and scan: a block's threads,
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowItems = 8;               // rows a thread,
constexpr int kRowTile = kRowThreads * kRowItems;  // 4096 rows a partition,
constexpr int kRowBlocksPerSm = 2;         // blocks an SM
// The scratch's header: the setup's flag, a ticket a pass, and the
// [kMaxPasses][kBins] global digit table (16 B aligned after it); the rows'
// depth order also takes a ticket for its prep and its scan, and keeps its
// number of kept rows as an int64.
constexpr int kTicketWord = 1;
constexpr int kPrepTicketWord = kTicketWord + kDepthPasses;
constexpr int kScanTicketWord = kPrepTicketWord + 1;
constexpr int kLiveRowsWord = 8;
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
constexpr uint32_t kSentinelWord = 0xFFFFFFFFu;  // a SENTINEL's low word
// The scatter's dynamic shared memory with records of `cols` columns: two
// partitions' records (the current one and the next one's stage), the
// per-warp bin counters (later the inverse map), the partition's bin
// counts, the local and global bin offsets, the scan sums.
constexpr int scatter_smem(int cols) {
  return (2 * cols * kTile + kWarps * kBins + 3 * kBins + 32) * 4;
}
constexpr int kScatterSmem = scatter_smem(3);

static_assert(kThreads >= kBins && kThreads % 32 == 0, "a thread a bin in the per-bin steps");
static_assert(kTile <= 0x10000 && kTile % 4 == 0, "places pack two to a register; whole vectors");
static_assert(kDigitBits + 1 + 5 + 6 <= 32, "a digit, the lanes below and its peers in one word");
static_assert(kWarps * kBins * 4 >= kTile * 2, "the inverse map fits over the warp counters");
static_assert(kHeaderWords % 4 == 0, "the status words start 16 B aligned");
static_assert(kScanTicketWord < kLiveRowsWord && kLiveRowsWord % 2 == 0 &&
                  kLiveRowsWord + 2 <= kHistWord,
              "the rows' tickets and int64 count fit the header");
static_assert(kRowItems * kRowWarps <= kRowThreads,
              "a thread a (round, warp) total in a partition scan");
static_assert(kScatterSmem <= 227 * 1024 &&
                  kScatterBlocksPerSm * (kScatterSmem + 1024 + 32) <= 228 * 1024,
              "the scatter blocks an SM fit its shared memory");

#if VK3D_RADIX_PHASES
constexpr int kPhaseParts = 4096;  // partitions stamped a pass
constexpr int kPhaseSlots = 13;
__device__ unsigned long long g_phases[kMaxPasses][kPhaseParts][kPhaseSlots];
#define RADIX_PHASE_AT(q, k, v) \
  if (tid == 0 && (q) < kPhaseParts) g_phases[p.pass][q][k] = (v)
#define RADIX_PHASE(k, v) RADIX_PHASE_AT(part, k, v)
#define RADIX_PHASE_SYNC() __syncthreads()
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
#define RADIX_PHASE_AT(q, k, v) ((void)0)
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

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Hopper's bulk copy: `bytes` (a multiple of 16, both ends 16 B aligned)
// from global to shared memory, counted against the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t* smem, const uint32_t* gmem, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          shared_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_addr(bar)) : "memory");
}

// The one arrival of the barrier's phase, which then completes when `bytes`
// have landed.
__device__ __forceinline__ void mbarrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(shared_addr(smem)), "l"(gmem)
               : "memory");
}

// Closes the thread's cp.async group (an empty one without copies).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits for every cp.async group of the thread.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
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
// the permutation, and the flag set if an input slot there is not SENTINEL
// in every column; depth and out_depth are NULL without the depth column.
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
    bad |= tile[i] != kSentinel || (depth != nullptr && depth[i] != kSentinel) ||
           index[i] != kSentinel;
    out_tile[i] = kSentinel;
    if (out_depth != nullptr) out_depth[i] = kSentinel;
    out_index[i] = kSentinel;
    if (out_perm != nullptr) out_perm[i] = i;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1u;
}

// (a) Every pass's digit counts of [0, n) into hist[passes][kBins], and the
// status words zeroed.  kDepth: the full key, four depth digits under the
// tile' digits; else the tile key, whose histogram reads the tile alone.
template <bool kDepth>
__global__ void __launch_bounds__(kHistThreads) radix_histogram_kernel(
    const int64_t* __restrict__ tile, const int64_t* __restrict__ depth,
    const int64_t* __restrict__ count, const uint32_t* __restrict__ flag, uint32_t e,
    uint32_t num_tiles, int passes, uint32_t* __restrict__ hist, uint4* __restrict__ status,
    size_t status_vecs) {
  constexpr int kTilePass = kDepth ? kDepthPasses : 0;  // the first tile' digit's pass
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
        // The low words, as the first scatter stages them.
        const auto t32 = static_cast<uint32_t>(__ldcs(reinterpret_cast<const long long*>(tile) + i));
        if (kDepth) {
          d[k] = static_cast<uint32_t>(__ldcs(reinterpret_cast<const long long*>(depth) + i));
        }
        t[k] = t32 == kSentinelWord ? num_tiles : t32;
      }
    }
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      if (base + k * kHistThreads + threadIdx.x < n) {
#pragma unroll
        for (int q = 0; q < kTilePass; ++q) {
          atomicAdd(&bins[q * kBins + ((d[k] >> (kDigitBits * q)) & (kBins - 1))], 1u);
        }
        for (int q = kTilePass; q < passes; ++q) {
          atomicAdd(&bins[q * kBins + ((t[k] >> (kDigitBits * (q - kTilePass))) & (kBins - 1))],
                    1u);
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
  const int64_t* depth64;  // also the last pass's gather by slot; depth64
  const int64_t* index64;  // NULL with two columns)
  const uint32_t* in;      // [kCols][stride] (depth,) tile', payload (later passes)
  uint32_t* out;           // [kCols][stride] (all passes but the last)
  int64_t* out_tile;       // the int64 outputs (last pass; out_depth NULL
  int64_t* out_depth;      // with two columns)
  int64_t* out_index;
  int64_t* out_perm;       // NULL: no permutation; the payload is the id
  int32_t* out_rows;       // the rows' last pass: [6][e] int32, as K1 reads them
  const int64_t* cum;      // the rows: K7's scan, for the count of a row marked in its h
  int64_t capacity;        // the rows: E
  int bx, by;              // the rows: the packed word's min_x and min_y bits
  const uint32_t* hist;    // this pass's [kBins] digit counts
  uint32_t* status;        // this pass's [partitions][kBins] look-back words
  uint32_t* ticket;        // this pass's partition ticket
  const int64_t* count;
  const uint32_t* flag;
  uint32_t e;
  uint32_t stride;         // words between the record columns: e rounded up to 4
  uint32_t num_tiles;
  int column;              // the digit's record column: depth 0, tile' kCols - 2
  int shift;
  int pass;
};

// The rows' packed word: min_x (bx bits), min_y (by), max(w, 1) (bx), and h
// in the bits above them, all ones for a row whose kept count is read from
// the scan.
struct RowFields {
  uint32_t min_x, min_y, gw, h;
};

__device__ __forceinline__ uint32_t h_shift(int bx, int by) { return 2 * bx + by; }

__device__ __forceinline__ uint32_t h_marker(int bx, int by) {
  return 0xFFFFFFFFu >> h_shift(bx, by);
}

__device__ __forceinline__ uint32_t pack_row(const RowFields& f, int bx, int by) {
  return f.min_x | (f.min_y << bx) | (f.gw << (bx + by)) | (f.h << h_shift(bx, by));
}

__device__ __forceinline__ RowFields unpack_row(uint32_t w, int bx, int by) {
  return {w & ((1u << bx) - 1u), (w >> bx) & ((1u << by) - 1u),
          (w >> (bx + by)) & ((1u << bx) - 1u), w >> h_shift(bx, by)};
}

// A row's kept slots: its share of [0, E) in K7's index-order expansion.
__device__ __forceinline__ uint32_t kept_count(const int64_t* cum, uint32_t row, int64_t capacity) {
  const int64_t end = cum[row];
  const int64_t start = row > 0 ? cum[row - 1] : 0;
  return static_cast<uint32_t>((end < capacity ? end : capacity) -
                               (start < capacity ? start : capacity));
}

// Starts the staging of the records of the partition at `start`, [0, cnt)
// of each column, into `buf` ([kCols][kTile]).  The first pass copies the
// low words of the int64 columns (their uint32 values) 4 B at a time with
// cp.async, every thread its share, the payload only when it is the id,
// closed as one cp.async group.  Later passes have thread 0 copy each
// padded uint32 column with one bulk copy (a segment starts 16 B aligned,
// and its rounded-up end stays inside the column's padding): the digit's
// column counted on `bars[0]`, the others on `bars[1]`, so that the count
// waits for the digit's column alone.  `wait_digits` and `wait_records`
// wait for them.
template <bool kFirst, int kCols>
__device__ __forceinline__ void stage_partition(const Pass& p, uint32_t start, uint32_t cnt,
                                                uint32_t* buf, uint64_t* bars) {
  constexpr int kTileCol = kCols - 2;
  if (kFirst) {
    const auto* t32 = reinterpret_cast<const uint32_t*>(p.tile64 + start);
    const auto* i32 = reinterpret_cast<const uint32_t*>(p.index64 + start);
    const bool payload = p.out_perm == nullptr;
    for (uint32_t i = threadIdx.x; i < cnt; i += kThreads) {
      if constexpr (kCols == 3) {
        cp_async4(buf + i, reinterpret_cast<const uint32_t*>(p.depth64 + start) + 2 * i);
      }
      cp_async4(buf + kTileCol * kTile + i, t32 + 2 * i);
      if (payload) cp_async4(buf + (kTileCol + 1) * kTile + i, i32 + 2 * i);
    }
    cp_async_commit();
  } else if (threadIdx.x == 0) {
    const uint32_t bytes = 16 * ((cnt + 3) / 4);
    // The buffer's last reads (the previous partition's stores, before the
    // block's barrier) are ordered before the copy's writes.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbarrier_expect(&bars[0], bytes);
    mbarrier_expect(&bars[1], (kCols - 1) * bytes);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = (p.column + c) % kCols;  // the digit's column first
      bulk_copy(buf + col * kTile, p.in + col * static_cast<size_t>(p.stride) + start, bytes,
                &bars[c == 0 ? 0 : 1]);
    }
  }
}

// Waits for the digit's column of a stage into buffer b (its barrier
// `bars[2 b]` at the parity in bit 2 b of `parities`, which flips); a
// barrier of the block must follow.  The first pass waits for all three.
template <bool kFirst>
__device__ __forceinline__ void wait_digits(uint64_t* bars, uint32_t b, uint32_t& parities) {
  if (kFirst) {
    cp_async_wait_all();
  } else {
    mbarrier_wait(bars + 2 * b, (parities >> (2 * b)) & 1u);
    parities ^= 1u << (2 * b);
  }
}

// Waits for the other columns of a stage into buffer b (bars[2 b + 1],
// bit 2 b + 1); each thread sees them once its own wait returns.
template <bool kFirst>
__device__ __forceinline__ void wait_records(uint64_t* bars, uint32_t b, uint32_t& parities) {
  if (!kFirst) {
    mbarrier_wait(bars + 2 * b + 1, (parities >> (2 * b + 1)) & 1u);
    parities ^= 1u << (2 * b + 1);
  }
}

// Counts the partition's digits (step 2): each element's digit, with the
// lanes below it and its peers in its round (__match_any_sync) beside it
// in dr (9 + 5 + 6 bits; an invalid slot carries the digit kBins), and the
// round's lowest peer adds their number to the partition's count of the
// digit in bcount.  `sentinel_to`: a staged tile's SENTINEL word counts as
// this value (num_tiles, the first pass of the tile key), or 0: no map.
__device__ __forceinline__ void count_partition(const uint32_t* dcol, uint32_t cnt, int shift,
                                                uint32_t sentinel_to, uint32_t wbase,
                                                uint32_t below_mask, uint32_t* bcount,
                                                uint32_t (&dr)[kItems]) {
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t i = wbase + 32 * j;
    uint32_t v = i < cnt ? dcol[i] : 0u;
    if (sentinel_to != 0 && v == kSentinelWord) v = sentinel_to;
    const uint32_t d = i < cnt ? (v >> shift) & (kBins - 1) : kBins;
    const uint32_t peers = __match_any_sync(kFull, d);
    const uint32_t below = __popc(peers & below_mask);
    if (d < kBins && below == 0) atomicAdd(&bcount[d], __popc(peers));
    dr[j] = d | (below << (kDigitBits + 1)) | (__popc(peers) << (kDigitBits + 6));
  }
}

// (b) One digit's chained-scan scatter: a persistent block's pipeline over
// its tickets (steps 1-5 and the loop at the top of the file).  kFirst: the
// sort's first pass, staged from the int64 columns; kLast: its last, which
// stores the int64 columns, or with kRows the rows' six int32 columns.
// kCols: the record's columns, 3 (depth, tile', payload) or 2 (tile',
// payload).
template <bool kFirst, bool kLast, bool kRows, int kCols>
__global__ void __launch_bounds__(kThreads, kScatterBlocksPerSm) radix_scatter_kernel(const Pass p) {
  static_assert(!kRows || (kLast && !kFirst && kCols == 3),
                "the rows' records are prepped; kRows is a last pass");
  static_assert(kCols == 2 || kCols == 3, "a record is (depth,) tile', payload");
  constexpr int kStage = kCols * kTile;     // words of a partition's record buffer
  constexpr int kTileCol = kCols - 2;       // tile's record column
  extern __shared__ __align__(16) uint32_t smem[];  // [2][kStage] the record buffers, then:
  __shared__ uint32_t s_ticket;
  __shared__ uint64_t s_bar[4];  // the record buffers' bulk copies: [buffer][digits, the rest]
  uint32_t* whist = smem + 2 * kStage;            // [kWarps][kBins]
  uint32_t* bcount = whist + kWarps * kBins;      // [kBins] a partition's counts
  uint32_t* local_off = bcount + kBins;           // [kBins]
  uint32_t* gdelta = local_off + kBins;           // [kBins] global - local place
  uint32_t* sums = gdelta + kBins;                // [32]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Lane l of warp w holds the partition's slots 512 w + 32 j + l, j < 16.
  const uint32_t wbase = warp * kWarpSlots + lane;
  const uint32_t below_mask = (1u << lane) - 1u;
  const bool bin_thread = tid < kBins;
  uint32_t* wh = whist + warp * kBins;
  auto* inv = reinterpret_cast<uint16_t*>(whist);
  const uint32_t n = sorted_len(p.count, p.flag, p.e);
  const uint32_t sentinel_to = kFirst && p.column == kTileCol ? p.num_tiles : 0u;

  // The first partition: its ticket, its stage, its count (step 2) and its
  // AGGREGATE word (INCLUSIVE for partition 0).
  if (tid == 0) {
    s_ticket = atomicAdd(p.ticket, 1u);
    for (int i = 0; i < 4; ++i) mbarrier_init(&s_bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < kBins; i += kThreads) bcount[i] = 0;
  uint32_t parities = 0;
  __syncthreads();
  uint32_t part = s_ticket;
  if (part * kTile >= n) return;  // uniform over the block
  stage_partition<kFirst, kCols>(p, part * kTile,
                                 min(n - part * kTile, static_cast<uint32_t>(kTile)), smem, s_bar);
  RADIX_PHASE(1, clock64());
  wait_digits<kFirst>(s_bar, 0, parities);
  __syncthreads();
  RADIX_PHASE(12, clock64() - g_phases[p.pass][part][1]);
  uint32_t dr[kItems];
  count_partition(smem + p.column * kTile, min(n - part * kTile, static_cast<uint32_t>(kTile)),
                  p.shift, sentinel_to, wbase, below_mask, bcount, dr);
  __syncthreads();
  uint32_t run = 0;
  if (bin_thread) {
    run = bcount[tid];
    store_status(p.status + static_cast<size_t>(part) * kBins + tid,
                 (part == 0 ? kInclusive : kAggregate) | run);
  }
#if VK3D_RADIX_PHASES
  unsigned long long ahead = 0;  // this partition was staged during the block's previous one
#endif
  // Buffer b holds `part`'s records, counted in dr and run; the next
  // partition stages into 1 - b.
  for (uint32_t b = 0;; b ^= 1u) {
    const uint32_t* s_col = smem + b * kStage;
    const uint32_t start = part * kTile;
    const uint32_t cnt = min(n - start, static_cast<uint32_t>(kTile));
    RADIX_PHASE(0, global_ns());
    RADIX_PHASE(1, clock64());
    // The last partition's stores have read the buffer the next partition
    // stages into, the inverse map and gdelta, and every thread has read
    // bcount and s_ticket.  The next ticket's round trip runs under this
    // partition's ranking.
    __syncthreads();
    uint32_t ticket = 0;
    if (tid == 0) ticket = atomicAdd(p.ticket, 1u);
    for (int i = tid; i < (kWarps + 1) * kBins; i += kThreads) whist[i] = 0;
    __syncthreads();

    // 3. This partition's rank among the equal digits of the warp's earlier
    // slots replaces the lanes below; then (after the next partition's
    // stage is issued) per bin the warps' counts become their offsets in
    // warp order, and the bins' local offsets and global bases are scanned.
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
    if (tid == 0) s_ticket = ticket;
    __syncthreads();
    RADIX_PHASE(2, clock64());
    // 1. The next partition's stage, into the other buffer.  Every later
    // ticket is past the live prefix once this one is.
    const uint32_t next = s_ticket;
    const bool more = next * kTile < n;  // uniform over the block
    const uint32_t next_cnt = more ? min(n - next * kTile, static_cast<uint32_t>(kTile)) : 0u;
    if (more) {
      stage_partition<kFirst, kCols>(p, next * kTile, next_cnt, smem + (b ^ 1u) * kStage,
                                     s_bar + 2 * (b ^ 1u));
    }
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
    // register; then the inverse map as uint16 over the warp counters,
    // which are read until the barrier.
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
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t i = wbase + 32 * j;
      if (i < cnt) inv[(pos[j / 2] >> (16 * (j % 2))) & 0xFFFFu] = static_cast<uint16_t>(i);
    }
    RADIX_PHASE(5, clock64());

    // 2. The next partition's count and AGGREGATE word, ahead of this
    // partition's look-back, so that no later partition's look-back waits
    // on it while this block looks back and stores.
    uint32_t next_run = 0;
    if (more) {
      wait_digits<kFirst>(s_bar, b ^ 1u, parities);
      __syncthreads();
      RADIX_PHASE_AT(next, 12, clock64() - g_phases[p.pass][part][5]);
      count_partition(smem + (b ^ 1u) * kStage + p.column * kTile, next_cnt, p.shift,
                      sentinel_to, wbase, below_mask, bcount, dr);
      __syncthreads();
      if (bin_thread) {
        next_run = bcount[tid];
        store_status(p.status + static_cast<size_t>(next) * kBins + tid, kAggregate | next_run);
      }
    }
    RADIX_PHASE(6, clock64());

    // 4. The look-back, placed after the partition's own work so that its
    // predecessors have had the longest time to publish.  The words below
    // k are read kLookBack at a time, all in flight at once, and summed
    // from the nearest down to the first INCLUSIVE one; an unpublished
    // word ends the window, and the walk waits on it alone before it reads
    // the next window from there.  Partition 0 is INCLUSIVE from the start,
    // so the walk ends there at the latest (and never reads below it).
    if (bin_thread) {
      uint32_t excl = 0;
      if (part > 0) {
#if VK3D_RADIX_PHASES
        unsigned long long steps = 0;
#endif
        for (uint32_t k = part;;) {
          uint32_t w[kLookBack];
#pragma unroll
          for (int i = 0; i < kLookBack; ++i) {
            w[i] = i < k ? load_status(p.status + static_cast<size_t>(k - 1 - i) * kBins + tid)
                         : kInclusive;
          }
          uint32_t used = kLookBack;
          bool done = false;
#pragma unroll
          for (int i = 0; i < kLookBack; ++i) {
            if (!done && used == kLookBack) {
              if (w[i] < kAggregate) {
                used = i;
              } else {
                excl += w[i] & kCountMask;
                done = w[i] >= kInclusive;
#if VK3D_RADIX_PHASES
                ++steps;
#endif
              }
            }
          }
          if (done) break;
          k -= used;
          if (used == 0) {
            const uint32_t* wait = p.status + static_cast<size_t>(k - 1) * kBins + tid;
            while (load_status(wait) < kAggregate) {
            }
          }
        }
        store_status(p.status + static_cast<size_t>(part) * kBins + tid, kInclusive | (excl + run));
        RADIX_PHASE(10, steps);
      }
      gdelta[tid] = gbase + excl - lo;
    }
    RADIX_PHASE(7, clock64());
    __syncthreads();

    // 5. Thread t writes sorted places t, t + kThreads, ... of every
    // column, reading each record where step 1 staged it.
    wait_records<kFirst>(s_bar, b, parities);
#pragma unroll 4
    for (int j = 0; j < kItems; ++j) {
      const uint32_t i = j * kThreads + tid;
      if (i < cnt) {
        const uint32_t src = inv[i];
        const uint32_t dk = kCols == 3 ? s_col[src] : 0u;
        uint32_t tk = s_col[kTileCol * kTile + src];
        if (kFirst && tk == kSentinelWord) tk = p.num_tiles;
        const uint32_t pk = kFirst && p.out_perm != nullptr
                                ? start + src
                                : s_col[(kTileCol + 1) * kTile + src];
        const uint32_t g =
            gdelta[((p.column == kTileCol ? tk : dk) >> p.shift) & (kBins - 1)] + i;
        if (kRows) {
          // tk is the packed word, pk the row id.
          const RowFields f = unpack_row(tk, p.bx, p.by);
          const uint32_t kept =
              f.h == h_marker(p.bx, p.by) ? kept_count(p.cum, pk, p.capacity) : f.gw * f.h;
          const uint32_t vals[6] = {pk, kept, f.gw, f.min_x, f.min_y, dk};
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            __stcs(reinterpret_cast<int*>(p.out_rows) + c * static_cast<size_t>(p.e) + g,
                   static_cast<int>(vals[c]));
          }
        } else if (kLast) {
          auto* out_tile = reinterpret_cast<long long*>(p.out_tile);
          auto* out_depth = reinterpret_cast<long long*>(p.out_depth);
          auto* out_index = reinterpret_cast<long long*>(p.out_index);
          if (kCols == 3) __stcs(out_depth + g, static_cast<long long>(dk));
          __stcs(out_tile + g, tk == p.num_tiles ? kSentinel : static_cast<long long>(tk));
          if (p.out_perm != nullptr) {
            __stcs(out_index + g, __ldg(reinterpret_cast<const long long*>(p.index64) + pk));
            __stcs(reinterpret_cast<long long*>(p.out_perm) + g, static_cast<long long>(pk));
          } else {
            __stcs(out_index + g, static_cast<long long>(pk));
          }
        } else {
          if (kCols == 3) __stcs(p.out + g, dk);
          __stcs(p.out + kTileCol * static_cast<size_t>(p.stride) + g, tk);
          __stcs(p.out + (kTileCol + 1) * static_cast<size_t>(p.stride) + g, pk);
        }
      }
    }
    RADIX_PHASE_SYNC();
    RADIX_PHASE(8, clock64());
    RADIX_PHASE(9, global_ns());
    RADIX_PHASE(11, (static_cast<unsigned long long>(blockIdx.x) << 1) | ahead);
#if VK3D_RADIX_PHASES
    ahead = 1;
#endif
    if (!more) break;
    part = next;
    run = next_run;
  }
}

// A partition's scan in the rows' kernels, (c) and (e): v[j] holds element
// j * kRowThreads + tid of the partition (element order j, then warp, then
// lane); each becomes its inclusive prefix within the partition, and the
// partition's total is returned.  Every thread of the block must call it.
__device__ __forceinline__ uint32_t partition_scan(uint32_t (&v)[kRowItems], uint32_t* s_tot,
                                                   uint32_t* sums) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < kRowItems; ++j) {
    v[j] = warp_inclusive(v[j]);
    if (lane == 31) s_tot[j * kRowWarps + warp] = v[j];
  }
  __syncthreads();
  const uint32_t t = tid < kRowItems * kRowWarps ? s_tot[tid] : 0u;
  const uint32_t before = block_exclusive_scan(t, sums);
  if (tid < kRowItems * kRowWarps) s_tot[tid] = before;
  if (tid == kRowItems * kRowWarps - 1) sums[0] = before + t;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRowItems; ++j) v[j] += s_tot[j * kRowWarps + warp];
  const uint32_t total = sums[0];
  __syncthreads();  // s_tot and sums may be reused
  return total;
}

// Warp 0's decoupled look-back over one status word a partition: publishes
// partition `part`'s total, reads its predecessors' words 32 at a time, a
// lane a word from the nearest down, waits until each of them is published,
// sums them down to the nearest INCLUSIVE one, publishes its INCLUSIVE
// prefix, and returns its exclusive prefix to every lane.  Partitions are
// taken by ticket, so every predecessor's block is running or done, and
// every word below an INCLUSIVE one is published.
__device__ __forceinline__ uint32_t chained_prefix(uint32_t* status, uint32_t part,
                                                   uint32_t total) {
  const int lane = threadIdx.x & 31;
  if (part == 0) {
    if (lane == 0) store_status(status, kInclusive | total);
    return 0;
  }
  if (lane == 0) store_status(status + part, kAggregate | total);
  uint32_t excl = 0;
  for (int64_t below = part;; below -= 32) {
    const int64_t k = below - 1 - lane;
    uint32_t w = k >= 0 ? load_status(status + k) : kInclusive;
    while (__any_sync(kFull, w < kAggregate)) {
      if (w < kAggregate) w = load_status(status + k);
    }
    const unsigned inclusive = __ballot_sync(kFull, w >= kInclusive);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    uint32_t v = lane <= stop ? w & kCountMask : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    excl += v;
    if (inclusive) break;
  }
  if (lane == 0) store_status(status + part, kInclusive | (excl + total));
  return excl;
}

// The next partition's ticket, for every thread of a persistent rows block
// (`s_part` shared); a barrier must separate two calls.
__device__ __forceinline__ uint32_t next_ticket(uint32_t* ticket, uint32_t* s_part) {
  if (threadIdx.x == 0) *s_part = atomicAdd(ticket, 1u);
  __syncthreads();
  return *s_part;
}

struct RowsPrep {
  const int32_t* cols;     // K7's [6][n] int32 rows
  const int64_t* cum;      // K7's inclusive scan of the counts
  uint32_t n;
  int64_t capacity;
  int bx, by;
  uint32_t* rec;           // [3][stride] the kept rows' records, in id order
  uint32_t stride;
  uint32_t* hist;          // [kDepthPasses][kBins]
  uint32_t* status;        // a word a partition
  uint32_t* ticket;
  int64_t* kept_rows;      // m
  uint4* zero;             // the passes' and the scan's status words
  size_t zero_vecs;
};

// (c) The rows' records, compacted, and the depth key's digit counts: a
// persistent block takes kRowTile-row partitions by ticket, in order, and
// adds its digit counts to the global table once, at its end.
__global__ void __launch_bounds__(kRowThreads, kRowBlocksPerSm)
    radix_rows_prep_kernel(const RowsPrep q) {
  __shared__ uint32_t bins[kDepthPasses * kBins];
  __shared__ uint32_t s_tot[kRowItems * kRowWarps];
  __shared__ uint32_t sums[32];
  __shared__ uint32_t s_part, s_excl;
  const int tid = threadIdx.x;
  for (int k = tid; k < kDepthPasses * kBins; k += kRowThreads) bins[k] = 0;
  const size_t stride = static_cast<size_t>(gridDim.x) * kRowThreads;
  for (size_t k = static_cast<size_t>(blockIdx.x) * kRowThreads + tid; k < q.zero_vecs;
       k += stride) {
    q.zero[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  const uint32_t marker = h_marker(q.bx, q.by);
  const size_t n = q.n;
  const uint32_t last = (q.n - 1) / kRowTile;
  for (uint32_t part; (part = next_ticket(q.ticket, &s_part)) <= last;) {
    const uint32_t base = part * kRowTile;
    uint32_t depth[kRowItems], packed[kRowItems], pos[kRowItems];
    uint32_t kept_mask = 0;
#pragma unroll
    for (int j = 0; j < kRowItems; ++j) {
      const uint32_t i = base + j * kRowThreads + tid;
      depth[j] = packed[j] = pos[j] = 0;
      if (i < q.n) {
        const int64_t end = q.cum[i];
        const int64_t start = i > 0 ? q.cum[i - 1] : 0;
        const auto kept = static_cast<uint32_t>((end < q.capacity ? end : q.capacity) -
                                                (start < q.capacity ? start : q.capacity));
        RowFields f{static_cast<uint32_t>(q.cols[3 * n + i]),
                    static_cast<uint32_t>(q.cols[4 * n + i]),
                    static_cast<uint32_t>(q.cols[2 * n + i]), 0u};
        depth[j] = static_cast<uint32_t>(q.cols[5 * n + i]);
        if (kept > 0) {
          // h, unless the row keeps part of its count or its count is not
          // max(w, 1) h: then the marker.
          const uint32_t h = f.gw > 0 ? kept / f.gw : marker;
          f.h = end - start == kept && f.gw > 0 && h * f.gw == kept && h < marker ? h : marker;
          pos[j] = 1;
          kept_mask |= 1u << j;
        }
        packed[j] = pack_row(f, q.bx, q.by);
      }
    }
    const uint32_t total = partition_scan(pos, s_tot, sums);
    if (tid < 32) {
      const uint32_t excl = chained_prefix(q.status, part, total);
      if (tid == 0) {
        s_excl = excl;
        if (part == last) *q.kept_rows = excl + total;
      }
    }
    __syncthreads();
    const uint32_t excl = s_excl;
#pragma unroll
    for (int j = 0; j < kRowItems; ++j) {
      if (kept_mask >> j & 1u) {
        const uint32_t at = excl + pos[j] - 1;
        q.rec[at] = depth[j];
        q.rec[q.stride + at] = packed[j];
        q.rec[2 * static_cast<size_t>(q.stride) + at] = base + j * kRowThreads + tid;
#pragma unroll
        for (int d = 0; d < kDepthPasses; ++d) {
          atomicAdd(&bins[d * kBins + ((depth[j] >> (kDigitBits * d)) & (kBins - 1))], 1u);
        }
      }
    }
    __syncthreads();  // every thread has read s_excl
  }
  for (int k = tid; k < kDepthPasses * kBins; k += kRowThreads) {
    if (bins[k] != 0) atomicAdd(&q.hist[k], bins[k]);
  }
}

// (e) The kept counts in depth order (rows' column 1, [0, m)) scanned: the
// inclusive scan into `cum`, the exclusive one over the column; rows at and
// past m keep 0.  Persistent blocks take kRowTile-row partitions by ticket.
__global__ void __launch_bounds__(kRowThreads, kRowBlocksPerSm) radix_rows_scan_kernel(
    int32_t* __restrict__ kept, int64_t* __restrict__ cum, uint32_t n,
    const int64_t* __restrict__ kept_rows, uint32_t* __restrict__ status,
    uint32_t* __restrict__ ticket) {
  __shared__ uint32_t s_tot[kRowItems * kRowWarps];
  __shared__ uint32_t sums[32];
  __shared__ uint32_t s_part, s_excl;
  const int tid = threadIdx.x;
  const auto m = static_cast<uint32_t>(*kept_rows);
  const uint32_t last = (n - 1) / kRowTile;
  for (uint32_t part; (part = next_ticket(ticket, &s_part)) <= last;) {
    const uint32_t base = part * kRowTile;
    uint32_t v[kRowItems], inc[kRowItems];
#pragma unroll
    for (int j = 0; j < kRowItems; ++j) {
      const uint32_t i = base + j * kRowThreads + tid;
      v[j] = i < m ? static_cast<uint32_t>(kept[i]) : 0u;
      inc[j] = v[j];
    }
    const uint32_t total = partition_scan(inc, s_tot, sums);
    if (tid < 32) {
      const uint32_t excl = chained_prefix(status, part, total);
      if (tid == 0) s_excl = excl;
    }
    __syncthreads();
    const uint32_t excl = s_excl;
#pragma unroll
    for (int j = 0; j < kRowItems; ++j) {
      const uint32_t i = base + j * kRowThreads + tid;
      if (i < n) {
        cum[i] = excl + inc[j];
        kept[i] = static_cast<int32_t>(excl + inc[j] - v[j]);
      }
    }
    __syncthreads();  // every thread has read s_excl
  }
}

// The rows kernels' persistent grid on `device`: kRowBlocksPerSm blocks an
// SM, at most `nparts`.
cudaError_t rows_grid(int device, uint32_t nparts, uint32_t* blocks) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const uint32_t resident = static_cast<uint32_t>(sms) * kRowBlocksPerSm;
  *blocks = resident < nparts ? resident : nparts;
  return cudaSuccess;
}

// The scatter's grid for `device`: its SMs times the blocks an SM that the
// kernel's occupancy allows.  Above 48 KB of shared memory needs the
// kernel's opt-in, a host call made once a device per process with the
// occupancy query (cached for devices below 64, asked every time from 64
// on); a refused call is returned and asked again next time.  The carveout
// asks for the most shared memory, so the block's 211 KiB (147 KiB with two
// columns) fit an SM.
template <bool kFirst, bool kLast, bool kRows, int kCols>
cudaError_t scatter_grid(int device, uint32_t* blocks) {
  static std::atomic<uint32_t> cached[64];
  const bool cacheable = device >= 0 && device < 64;
  if (cacheable && (*blocks = cached[device].load(std::memory_order_acquire)) != 0) {
    return cudaSuccess;
  }
  const auto kernel = radix_scatter_kernel<kFirst, kLast, kRows, kCols>;
  constexpr int kSmem = scatter_smem(kCols);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  int per_sm = 0;
  int sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<uint32_t>(per_sm) * static_cast<uint32_t>(sms);
  if (cacheable) cached[device].store(*blocks, std::memory_order_release);
  return cudaSuccess;
}

template <bool kFirst, bool kLast, bool kRows, int kCols>
cudaError_t launch_scatter(const Pass& p, uint32_t nparts, int device, cudaStream_t s) {
  uint32_t blocks = 0;
  const cudaError_t err = scatter_grid<kFirst, kLast, kRows, kCols>(device, &blocks);
  if (err != cudaSuccess) return err;
  radix_scatter_kernel<kFirst, kLast, kRows, kCols>
      <<<blocks < nparts ? blocks : nparts, kThreads, scatter_smem(kCols), s>>>(p);
  return cudaGetLastError();
}

// One digit pass of vk3d_radix_sort on records of kCols columns.
template <int kCols>
cudaError_t launch_sort_pass(const Pass& p, bool first, bool last, uint32_t nparts, int device,
                             cudaStream_t s) {
  return first ? (last ? launch_scatter<true, true, false, kCols>(p, nparts, device, s)
                       : launch_scatter<true, false, false, kCols>(p, nparts, device, s))
               : (last ? launch_scatter<false, true, false, kCols>(p, nparts, device, s)
                       : launch_scatter<false, false, false, kCols>(p, nparts, device, s));
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
// The last sort's phase stamps, [kMaxPasses][4096][12] uint64, into `out`
// (host memory): per pass and partition the global ns at the start, thread
// 0's clock at the start, after the next partition's ticket and stage
// issue, after the wait for this partition's stage, after steps 2-3, the
// scans, the inverse map and its look-back, at the end, the global ns at
// the end, bin 0's look-back length in words, and the block's index times
// 2 plus 1 if the partition was staged ahead.
extern "C" int vk3d_radix_phases(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases)));
}
#endif

// The scatter's persistent grid on `device` (its SMs times the blocks an
// SM that the kernel's occupancy allows), or minus the CUDA error.
extern "C" int64_t vk3d_radix_resident_blocks(int32_t device) {
  cudaError_t err = cudaSetDevice(device);
  uint32_t blocks = 0;
  if (err == cudaSuccess) err = scatter_grid<false, false, false, 3>(device, &blocks);
  return err == cudaSuccess ? static_cast<int64_t>(blocks) : -static_cast<int64_t>(err);
}

// Sorts the [e] int64 columns tile, depth, index (uint32 values; tiles below
// num_tiles or SENTINEL) by `key`, stably: kKeyTileDepth (tile, depth),
// kKeyTile the tile alone; into out_tile, out_depth, out_index, and the slot
// permutation into out_perm unless it is NULL.  depth NULL (kKeyTile only):
// two-column records, tile and index alone, out_depth not written.  count:
// a [] int64 on the device bounding the sorted prefix, or NULL for every
// slot.  e < 2^30 (the status words' counts).  scratch: radix_kernel.scratch_words(e, num_tiles,
// key) uint32 words, 16 B aligned (the header, the [passes][partitions][256]
// status words, two [3][e rounded up to 4] record buffers).  *launches
// receives the number of kernels launched.
extern "C" int vk3d_radix_sort(const void* tile, const void* depth, const void* index,
                               const void* count, int64_t e, int64_t num_tiles, int32_t key,
                               void* scratch, void* out_tile, void* out_depth, void* out_index,
                               void* out_perm, int64_t* launches, int32_t device, void* stream) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e < 0 || e >= (int64_t{1} << kStatusCountBits) || num_tiles <= 0 ||
      num_tiles >= (int64_t{1} << 31) || reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      (key != kKeyTileDepth && key != kKeyTile) || (depth == nullptr && key != kKeyTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0) return static_cast<int>(cudaSuccess);
  const int cols = depth == nullptr ? 2 : 3;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ne = static_cast<uint32_t>(e);
  const uint32_t nparts = (ne + kTile - 1) / kTile;
  const bool with_depth = key == kKeyTileDepth;
  const int depth_passes = with_depth ? kDepthPasses : 0;
  const int passes =
      (kDigitBits * depth_passes + bit_length(num_tiles) + kDigitBits - 1) / kDigitBits;
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
  p.out_depth = cols == 3 ? static_cast<int64_t*>(out_depth) : nullptr;
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
  const uint32_t hist_blocks = hist_need < kHistBlocks ? hist_need : kHistBlocks;
  const auto histogram = with_depth ? radix_histogram_kernel<true> : radix_histogram_kernel<false>;
  histogram<<<hist_blocks, kHistThreads, 0, s>>>(p.tile64, p.depth64, p.count, flag, ne,
                                                 p.num_tiles, passes, hist,
                                                 reinterpret_cast<uint4*>(status),
                                                 status_words / 4);
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
    p.column = q < depth_passes ? 0 : cols - 2;
    p.shift = kDigitBits * (q < depth_passes ? q : q - depth_passes);
    p.pass = q;
    err = cols == 2 ? launch_sort_pass<2>(p, first, last, nparts, device, s)
                    : launch_sort_pass<3>(p, first, last, nparts, device, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return static_cast<int>(cudaSuccess);
}

// Puts keygen's n rows (K7's [6][n] int32 columns and their inclusive int64
// scan `cum`) in the stable order of their depth keys, each with its kept
// count at the capacity E: out_cols [6][n] int32 (id, the exclusive scan of
// the kept counts in that order, max(w, 1), min_x, min_y, depth bits) and
// out_cum [n] int64 (their inclusive scan), as K1 reads them.  The kept
// rows come first; a row past them keeps 0 slots and only its offset and
// scan are written.  min_x and max(w, 1) must be below 2^bit_length(grid_w)
// and min_y below 2^bit_length(grid_h), as K7 writes them, with
// 2 bit_length(grid_w) + bit_length(grid_h) <= 31;
// n < 2^30 and E < 2^30 (the status words' counts).  scratch:
// radix_kernel.depth_order_scratch_words(n) uint32 words, 16 B aligned (the
// header, the prep's and the scan's status words, a word a partition each
// rounded up to 4, the passes' [4][partitions][256] status words, two
// [3][n rounded up to 4] record buffers).  *launches receives the number of
// kernels launched.
extern "C" int vk3d_radix_depth_order(const void* cols, const void* cum, int64_t n,
                                      int64_t capacity, int64_t grid_w, int64_t grid_h,
                                      void* scratch, void* out_cols, void* out_cum,
                                      int64_t* launches, int32_t device, void* stream) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bx = bit_length(grid_w);
  const int by = bit_length(grid_h);
  if (n < 0 || n >= (int64_t{1} << kStatusCountBits) || capacity < 0 ||
      capacity >= (int64_t{1} << kStatusCountBits) || grid_w <= 0 || grid_h <= 0 ||
      2 * bx + by > 31 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nr = static_cast<uint32_t>(n);
  const uint32_t nparts = (nr + kTile - 1) / kTile;
  const uint32_t row_parts = (nr + kRowTile - 1) / kRowTile;
  const uint32_t part_words = (row_parts + 3) & ~3u;
  uint32_t row_blocks = 0;
  if ((err = rows_grid(device, row_parts, &row_blocks)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  uint32_t* header = static_cast<uint32_t*>(scratch);
  uint32_t* hist = header + kHistWord;
  auto* kept_rows = reinterpret_cast<int64_t*>(header + kLiveRowsWord);
  uint32_t* prep_status = header + kHeaderWords;
  uint32_t* scan_status = prep_status + part_words;
  uint32_t* status = scan_status + part_words;
  const size_t status_words = static_cast<size_t>(kDepthPasses) * nparts * kBins;
  const uint32_t stride = (nr + 3) & ~3u;
  uint32_t* a = status + status_words;
  uint32_t* b = a + 3 * static_cast<size_t>(stride);

  // The header (tickets, the digit table, the flag the passes read as 0)
  // and the prep's status words start at zero; the prep zeroes the rest.
  err = cudaMemsetAsync(header, 0, (kHeaderWords + part_words) * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  RowsPrep q{};
  q.cols = static_cast<const int32_t*>(cols);
  q.cum = static_cast<const int64_t*>(cum);
  q.n = nr;
  q.capacity = capacity;
  q.bx = bx;
  q.by = by;
  q.rec = b;
  q.stride = stride;
  q.hist = hist;
  q.status = prep_status;
  q.ticket = header + kPrepTicketWord;
  q.kept_rows = kept_rows;
  q.zero = reinterpret_cast<uint4*>(scan_status);
  q.zero_vecs = (part_words + status_words) / 4;
  radix_rows_prep_kernel<<<row_blocks, kRowThreads, 0, s>>>(q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launches;

  Pass p{};
  p.out_rows = static_cast<int32_t*>(out_cols);
  p.cum = q.cum;
  p.capacity = capacity;
  p.bx = bx;
  p.by = by;
  p.count = kept_rows;
  p.flag = header;
  p.e = nr;
  p.stride = stride;
  p.column = 0;
  // The prep wrote b: pass q reads what pass q - 1 wrote, even passes
  // write a, odd ones b, the last the rows.
  for (int pass = 0; pass < kDepthPasses; ++pass) {
    p.in = pass % 2 == 1 ? a : b;
    p.out = pass % 2 == 0 ? a : b;
    p.hist = hist + pass * kBins;
    p.status = status + static_cast<size_t>(pass) * nparts * kBins;
    p.ticket = header + kTicketWord + pass;
    p.shift = kDigitBits * pass;
    p.pass = pass;
    err = pass == kDepthPasses - 1 ? launch_scatter<false, true, true, 3>(p, nparts, device, s)
                                   : launch_scatter<false, false, false, 3>(p, nparts, device, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  radix_rows_scan_kernel<<<row_blocks, kRowThreads, 0, s>>>(
      static_cast<int32_t*>(out_cols) + n, static_cast<int64_t*>(out_cum), nr, kept_rows,
      scan_status, header + kScanTicketWord);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launches;
  return static_cast<int>(cudaSuccess);
}
