// The AUTO sort: an LSD radix sort of the sort elements over the used key
// bits.
//
// Not a TPU kernel: it replaces the JAX package's two `jax.lax.sort` calls
// on the sort elements, vk3dgaussiansplatting_tpu/ops/sort.py:37
// sort_elements_xla and parallel/dist.py:195 _sort3 (3 keys, unstable, the
// id as the third key), and takes the GPU shape of the reference's
// RadixSort (RadixSort.cpp:201-653: an LSD radix over the used bits of the
// GPU-side live count).  Its plain version is ops/sort.py:
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
// Per digit pass, three kernels:
//  (a) histogram: each block counts the digits of its 4096-slot tile in
//      per-warp shared-memory bins and stores the tile's 256 counts
//      bin-major, table[bin * nblocks + block] (the reference's sumTable);
//  (b) scan: a block per bin scans that bin's row over the blocks,
//      exclusive, and writes the bin's total;
//  (c) scatter: each block re-reads its tile and ranks each element among
//      the equal digits of the tile, in slot order: warp w holds the
//      tile's slots [512 w, 512 w + 512), 32 a round; in a round eight
//      ballots give each lane the lanes of its digit, and per-warp bin
//      counters in shared memory carry the counts from round to round;
//      then the warps' counts are scanned in warp order.  Each element goes
//      to its tile-local sorted place in shared memory, and each bin's run
//      is written out contiguously at the bin's base + the earlier blocks'
//      count of the bin + its place in the run.
// Records ping-pong between two scratch buffers as three uint32 columns
// (depth, tile', payload: the id, or the slot when the permutation is
// asked for).  The first scatter reads the int64 columns; the last writes
// the int64 tile, depth and index (the index gathered by slot when the
// permutation is asked for) and the int64 permutation.  No global atomic
// decides an order (the setup's flag is only ever set to 1): the result is
// deterministic and stable.
//
// What bounds it on the H100: bytes.  The function reads 24 B a live slot
// and writes 24 B a slot: 0.66 GB at garden (13.1M live of 14.19M), 0.20
// ms at 3.35 TB/s.  A radix sort must move each record once a pass: per
// pass the histogram reads the digit's column (4 B a slot, the first pass
// 8 B) and the scatter reads and writes 12 B a slot (the first reads 24 B,
// the last writes 24 B), 196 B a sorted slot over 6 passes, 0.77 ms at
// garden.  What the design does about it: it sorts only the used key bits
// and the live prefix, carries 12-byte records instead of a 64-bit key and
// a permutation, reads each column as coalesced 4-byte words, and writes
// each bin's run of a tile as one contiguous stretch, so the scattered
// writes fill whole sectors in L2.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // elements a thread
constexpr int kTile = kThreads * kItems;   // 4096 slots a block
constexpr int kWarpSlots = 32 * kItems;    // 512 slots a warp
constexpr int kBins = 256;                 // 8-bit digits
constexpr int kDigitBits = 8;
constexpr int kScanThreads = 512;
constexpr int kScanItems = 4;
constexpr int kSetupBlocks = 1056;         // 8 an SM, grid-striding over the tail
constexpr int64_t kSentinel = 0xFFFFFFFFll;  // core/config.py SENTINEL
constexpr unsigned kFull = 0xFFFFFFFFu;
// The scatter's shared memory: the tile's three record columns, the
// per-warp bin counters, the tile-local and global bin offsets, scan sums.
constexpr int kScatterSmem = (3 * kTile + kWarps * kBins + 2 * kBins + 32) * 4;

static_assert(kThreads == kBins, "one thread a bin in the per-bin steps");
static_assert(kItems % 2 == 0 && kWarpSlots <= 0x10000, "ranks pack two to a register");

// The sorted prefix's length: min(count, e), or e without a count or when
// the setup found a slot past the count that is not a SENTINEL triple.
__device__ __forceinline__ uint32_t sorted_len(const int64_t* count, const uint32_t* flag,
                                               uint32_t e) {
  if (count == nullptr || *flag != 0) return e;
  const int64_t c = *count;
  return c <= 0 ? 0u : (c >= static_cast<int64_t>(e) ? e : static_cast<uint32_t>(c));
}

__device__ __forceinline__ uint32_t digit_of(int column, int shift, uint32_t depth,
                                             uint32_t tile) {
  return ((column == 0 ? depth : tile) >> shift) & (kBins - 1);
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

// Exclusive scan of v over the block's threads (a multiple of 32); *total
// receives the block's sum.  `sums` is 32 words of shared memory; every
// thread of the block must call it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* sums,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t inc = warp_inclusive(v);
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) sums[lane] = warp_inclusive(lane < nwarps ? sums[lane] : 0u);
  __syncthreads();
  *total = sums[nwarps - 1];
  const uint32_t out = inc - v + (warp > 0 ? sums[warp - 1] : 0u);
  __syncthreads();  // sums may be reused
  return out;
}

// The tail [min(count, e), e): SENTINEL into the outputs, the identity into
// the permutation, and the flag set if an input slot there is not a
// SENTINEL triple.
__global__ void __launch_bounds__(kThreads) radix_setup_kernel(
    const int64_t* __restrict__ tile, const int64_t* __restrict__ depth,
    const int64_t* __restrict__ index, const int64_t* __restrict__ count, uint32_t e,
    uint32_t* __restrict__ flag, int64_t* __restrict__ out_tile, int64_t* __restrict__ out_depth,
    int64_t* __restrict__ out_index, int64_t* __restrict__ out_perm) {
  const int64_t c = *count;
  const uint32_t n = c <= 0 ? 0u : (c >= static_cast<int64_t>(e) ? e : static_cast<uint32_t>(c));
  bool bad = false;
  for (uint32_t i = n + blockIdx.x * kThreads + threadIdx.x; i < e; i += gridDim.x * kThreads) {
    bad |= tile[i] != kSentinel || depth[i] != kSentinel || index[i] != kSentinel;
    out_tile[i] = kSentinel;
    out_depth[i] = kSentinel;
    out_index[i] = kSentinel;
    if (out_perm != nullptr) out_perm[i] = i;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1u;
}

// (a) Each block's digit counts, bin-major.  The first pass reads the int64
// depth column, later ones the uint32 column holding the pass's digit.
template <bool kFirst>
__global__ void __launch_bounds__(kThreads) radix_histogram_kernel(
    const int64_t* __restrict__ depth64, const uint32_t* __restrict__ word,
    const int64_t* __restrict__ count, const uint32_t* __restrict__ flag, uint32_t e, int shift,
    uint32_t nblocks, uint32_t* __restrict__ table) {
  __shared__ uint32_t hist[kWarps * kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) hist[i] = 0;
  __syncthreads();
  const uint32_t n = sorted_len(count, flag, e);
  const uint32_t start = blockIdx.x * kTile;
  if (start < n) {
    const uint32_t cnt = min(n - start, static_cast<uint32_t>(kTile));
    uint32_t* mine = hist + (threadIdx.x >> 5) * kBins;
    uint32_t key[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t i = j * kThreads + threadIdx.x;
      key[j] = 0;
      if (i < cnt) {
        key[j] = kFirst ? static_cast<uint32_t>(depth64[start + i]) : word[start + i];
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (j * kThreads + threadIdx.x < cnt) atomicAdd(&mine[(key[j] >> shift) & (kBins - 1)], 1u);
    }
  }
  __syncthreads();
  uint32_t sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += hist[w * kBins + threadIdx.x];
  table[static_cast<size_t>(threadIdx.x) * nblocks + blockIdx.x] = sum;
}

// (b) A block per bin: the bin's row of the table scanned over the blocks,
// exclusive, in place; the bin's total into totals.
__global__ void __launch_bounds__(kScanThreads) radix_scan_kernel(
    uint32_t* __restrict__ table, uint32_t nblocks, uint32_t* __restrict__ totals) {
  __shared__ uint32_t sums[32];
  uint32_t* row = table + static_cast<size_t>(blockIdx.x) * nblocks;
  uint32_t carry = 0;
  for (uint32_t base = 0; base < nblocks; base += kScanThreads * kScanItems) {
    const uint32_t first = base + threadIdx.x * kScanItems;
    uint32_t v[kScanItems];
    uint32_t s = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = first + k < nblocks ? row[first + k] : 0u;
      s += v[k];
    }
    uint32_t total;
    uint32_t run = carry + block_exclusive_scan(s, sums, &total);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (first + k < nblocks) row[first + k] = run;
      run += v[k];
    }
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

struct Pass {
  const int64_t* tile64;   // the int64 input columns (first pass; index64
  const int64_t* depth64;  // also the last pass's gather by slot)
  const int64_t* index64;
  const uint32_t* in;      // [3][e] depth, tile', payload (later passes)
  uint32_t* out;           // [3][e] (all passes but the last)
  int64_t* out_tile;       // the int64 outputs (last pass)
  int64_t* out_depth;
  int64_t* out_index;
  int64_t* out_perm;       // NULL: no permutation; the payload is the id
  const uint32_t* table;   // scanned [256][nblocks]
  const uint32_t* totals;  // [256]
  const int64_t* count;
  const uint32_t* flag;
  uint32_t e;
  uint32_t nblocks;
  uint32_t num_tiles;
  int column;              // 0: the digit is in depth, 1: in tile'
  int shift;
};

// (c) The stable scatter of one tile (see the top of the file).
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads, 2) radix_scatter_kernel(const Pass p) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_depth = smem;
  uint32_t* s_tile = smem + kTile;
  uint32_t* s_pay = smem + 2 * kTile;
  uint32_t* whist = smem + 3 * kTile;         // [kWarps][kBins]
  uint32_t* local_off = whist + kWarps * kBins;  // [kBins]
  uint32_t* gdelta = local_off + kBins;        // [kBins] global - local place
  uint32_t* sums = gdelta + kBins;             // [32]

  const uint32_t n = sorted_len(p.count, p.flag, p.e);
  const uint32_t start = blockIdx.x * kTile;
  if (start >= n) return;  // uniform over the block
  const uint32_t cnt = min(n - start, static_cast<uint32_t>(kTile));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) whist[i] = 0;

  // Lane l of warp w holds the tile's slots 512 w + 32 j + l, j = 0 .. 15.
  const uint32_t wbase = warp * kWarpSlots + lane;
  uint32_t dk[kItems], tk[kItems], pk[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t i = wbase + 32 * j;
    dk[j] = tk[j] = pk[j] = 0;
    if (i < cnt) {
      const uint32_t s = start + i;
      if (kFirst) {
        const int64_t t = p.tile64[s];
        dk[j] = static_cast<uint32_t>(p.depth64[s]);
        tk[j] = t == kSentinel ? p.num_tiles : static_cast<uint32_t>(t);
        pk[j] = p.out_perm != nullptr ? s : static_cast<uint32_t>(p.index64[s]);
      } else {
        dk[j] = p.in[s];
        tk[j] = p.in[p.e + s];
        pk[j] = p.in[2 * static_cast<size_t>(p.e) + s];
      }
    }
  }
  __syncthreads();  // the counters are zero

  // Each element's rank among the equal digits of its warp's earlier slots
  // (below 512: two to a register, to keep the last pass within 128).
  const uint32_t below_mask = (1u << lane) - 1u;
  uint32_t* wh = whist + warp * kBins;
  uint32_t rank[kItems / 2] = {};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = wbase + 32 * j < cnt;
    const uint32_t d = digit_of(p.column, p.shift, dk[j], tk[j]);
    uint32_t peers = __ballot_sync(kFull, valid);
#pragma unroll
    for (int b = 0; b < kDigitBits; ++b) {
      const bool bit = (d >> b) & 1u;
      const uint32_t m = __ballot_sync(kFull, bit);
      peers &= bit ? m : ~m;
    }
    const uint32_t below = __popc(peers & below_mask);
    const uint32_t base = valid ? wh[d] : 0u;
    __syncwarp();
    if (valid && below == 0) wh[d] = base + __popc(peers);
    __syncwarp();
    rank[j / 2] |= (base + below) << (16 * (j % 2));
  }
  __syncthreads();

  // Per bin (thread t is bin t): the warps' counts become their exclusive
  // offsets in warp order; the tile's bin counts are scanned over the bins
  // (its local bin offsets), the bins' global totals likewise (their
  // bases).
  {
    const int t = threadIdx.x;
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = whist[w * kBins + t];
      whist[w * kBins + t] = run;
      run += c;
    }
    uint32_t total;
    const uint32_t lo = block_exclusive_scan(run, sums, &total);
    const uint32_t base = block_exclusive_scan(p.totals[t], sums, &total);
    local_off[t] = lo;
    gdelta[t] = base + p.table[static_cast<size_t>(t) * p.nblocks + blockIdx.x] - lo;
  }
  __syncthreads();

  // Each element to its tile-local sorted place.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (wbase + 32 * j < cnt) {
      const uint32_t d = digit_of(p.column, p.shift, dk[j], tk[j]);
      const uint32_t pos = local_off[d] + wh[d] + ((rank[j / 2] >> (16 * (j % 2))) & 0xFFFFu);
      s_depth[pos] = dk[j];
      s_tile[pos] = tk[j];
      s_pay[pos] = pk[j];
    }
  }
  __syncthreads();

  // Out in local order: each bin's run lands contiguously.  Four items in
  // flight a thread keep the last pass (int64 stores, the index gather)
  // within 128 registers.
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const uint32_t i = j * kThreads + threadIdx.x;
    if (i < cnt) {
      const uint32_t dd = s_depth[i];
      const uint32_t tt = s_tile[i];
      const uint32_t pp = s_pay[i];
      const uint32_t g = gdelta[digit_of(p.column, p.shift, dd, tt)] + i;
      if (kLast) {
        p.out_tile[g] = tt == p.num_tiles ? kSentinel : static_cast<int64_t>(tt);
        p.out_depth[g] = dd;
        if (p.out_perm != nullptr) {
          p.out_index[g] = p.index64[pp];
          p.out_perm[g] = pp;
        } else {
          p.out_index[g] = pp;
        }
      } else {
        p.out[g] = dd;
        p.out[p.e + g] = tt;
        p.out[2 * static_cast<size_t>(p.e) + g] = pp;
      }
    }
  }
}

template <bool kFirst, bool kLast>
cudaError_t launch_scatter(const Pass& p, unsigned int blocks, int device, cudaStream_t s) {
  // Above 48 KB of shared memory needs the kernel's opt-in, a host call
  // made once a device per process (a bit of `opted` each, devices from 64
  // on every time); a refused opt-in is returned and asked again next call.
  static std::atomic<uint64_t> opted{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit == 0 || !(opted.load(std::memory_order_acquire) & bit)) {
    cudaError_t err = cudaFuncSetAttribute(radix_scatter_kernel<kFirst, kLast>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kScatterSmem);
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

// Sorts the [e] int64 columns tile, depth, index (uint32 values; tiles below
// num_tiles or SENTINEL) by (tile, depth), stably, into out_tile, out_depth,
// out_index, and the slot permutation into out_perm unless it is NULL.
// count: a [] int64 on the device bounding the sorted prefix, or NULL for
// every slot.  scratch: radix_kernel.scratch_words(e) uint32 words (two
// [3][e] record buffers, the [256][nblocks] table, 256 totals, the flag).
// *launches receives the number of kernels launched.
extern "C" int vk3d_radix_sort(const void* tile, const void* depth, const void* index,
                               const void* count, int64_t e, int64_t num_tiles, void* scratch,
                               void* out_tile, void* out_depth, void* out_index, void* out_perm,
                               int64_t* launches, int32_t device, void* stream) {
  *launches = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e < 0 || e >= (int64_t{1} << 31) || num_tiles <= 0 || num_tiles >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ne = static_cast<uint32_t>(e);
  const uint32_t nblocks = (ne + kTile - 1) / kTile;
  uint32_t* a = static_cast<uint32_t*>(scratch);
  uint32_t* b = a + 3 * static_cast<size_t>(ne);
  uint32_t* table = b + 3 * static_cast<size_t>(ne);
  uint32_t* totals = table + static_cast<size_t>(kBins) * nblocks;
  uint32_t* flag = totals + kBins;

  Pass p{};
  p.tile64 = static_cast<const int64_t*>(tile);
  p.depth64 = static_cast<const int64_t*>(depth);
  p.index64 = static_cast<const int64_t*>(index);
  p.out_tile = static_cast<int64_t*>(out_tile);
  p.out_depth = static_cast<int64_t*>(out_depth);
  p.out_index = static_cast<int64_t*>(out_index);
  p.out_perm = static_cast<int64_t*>(out_perm);
  p.table = table;
  p.totals = totals;
  p.count = static_cast<const int64_t*>(count);
  p.flag = flag;
  p.e = ne;
  p.nblocks = nblocks;
  p.num_tiles = static_cast<uint32_t>(num_tiles);

  if (count != nullptr) {
    if ((err = cudaMemsetAsync(flag, 0, sizeof(uint32_t), s)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    const uint32_t tail_blocks = (ne + kThreads - 1) / kThreads;
    const uint32_t setup_blocks = tail_blocks < kSetupBlocks ? tail_blocks : kSetupBlocks;
    radix_setup_kernel<<<setup_blocks, kThreads, 0, s>>>(
        p.tile64, p.depth64, p.index64, p.count, ne, flag, p.out_tile, p.out_depth, p.out_index,
        p.out_perm);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }

  // Pass q reads what pass q - 1 wrote: even passes write a, odd ones b.
  const int passes = (32 + bit_length(num_tiles) + kDigitBits - 1) / kDigitBits;
  for (int q = 0; q < passes; ++q) {
    const bool first = q == 0;
    const bool last = q == passes - 1;
    p.in = q % 2 == 1 ? a : b;
    p.out = q % 2 == 0 ? a : b;
    p.column = q < 4 ? 0 : 1;
    p.shift = kDigitBits * (q < 4 ? q : q - 4);
    if (first) {
      radix_histogram_kernel<true><<<nblocks, kThreads, 0, s>>>(
          p.depth64, nullptr, p.count, flag, ne, p.shift, nblocks, table);
    } else {
      radix_histogram_kernel<false><<<nblocks, kThreads, 0, s>>>(
          nullptr, p.in + static_cast<size_t>(p.column) * ne, p.count, flag, ne, p.shift, nblocks,
          table);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    radix_scan_kernel<<<kBins, kScanThreads, 0, s>>>(table, nblocks, totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    err = first ? launch_scatter<true, false>(p, nblocks, device, s)
                : (last ? launch_scatter<false, true>(p, nblocks, device, s)
                        : launch_scatter<false, false>(p, nblocks, device, s));
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return static_cast<int>(cudaSuccess);
}
