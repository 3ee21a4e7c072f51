// Monotone fixed-capacity expansion — the InitSortList element allocation.
//
// Replaces the TPU kernels vk3dgaussiansplatting_tpu/ops/pallas/expand_kernel.py
// : expand_rows (_expand_kernel) and expand_rows_streamed (_stream_kernel),
// which differ only in their DMA schedule, and, in its decode variant, the
// per-slot decode after them (vk3dgaussiansplatting_tpu/ops/keygen.py:203-262).
// Computes, for ncols int32 columns of N source rows and the inclusive int64
// scan `cum` of their counts,
//
//     out[c][j] = cols[c][r(j)],  r(j) = #{i : cum[i] <= j},  j < min(total, E)
//     out[c][j] = 0,                                          otherwise
//
// i.e. repeat(cols, counts, total_repeat_length=E) with zeros in dead slots,
// in jnp.repeat's slot order.  The decode variant (vk3d_expand_elements)
// takes keygen's six columns (id, offset, max(w, 1), min_x, min_y, depth
// bits) and stores the sort elements in place of the rows: for a live slot
// j of row r, local = j - offset[r], ly = local / gw[r], lx = local - ly gw,
//
//     tile[j]  = (min_y[r] + ly) * grid_w + (min_x[r] + lx)
//     depth[j] = (uint32) depth_bits[r],   index[j] = id[r]
//
// as int64 (ops/cuda/expand_kernel.py:decode_slots_plain), SENTINEL in all
// three past min(total, E), and count = min(total, E).
//
// What bounds it on the H100: bytes.  The rows variant writes 4 * ncols * E
// bytes (6 columns at E = 14.2M is 340 MB); the decode variant writes the
// same 24 B a slot as three int64 columns, so the 24 B a live slot that a
// separate decode kernel would read back, and its launch, never happen.
// The column values of the rows that own slots and the scan are read once.
//
// Design: a load-balanced (merge-path) expansion.  The expansion is the
// merge of two sorted sequences, the N row ends cum[i] and the E slots j,
// where row end i goes before slot j iff cum[i] <= j: the row ends merged
// ahead of slot j are then exactly r(j) (r(j) = N for a slot past the total,
// which reads a zero row).  Row end i lands at merged position
// i + min(cum[i], E), a strictly increasing key, so the split of any
// diagonal d of the merge (row ends and slots among its first d items) is
// one lower-bound search over the scan.  Every block owns kItems consecutive
// merged items, row ends and slots together, so its work is the same
// whatever the run lengths: a gaussian covering thousands of tiles spans
// several blocks, a run of a million zero-count rows costs its scan reads,
// and the dead tail [min(total, E), E) is a block's zero (or SENTINEL) fill.
//
//   1. partition_kernel: one thread per block boundary finds its split.
//   2. expand_rows_kernel: the block loads the scan entries of its row ends
//      and the column values of the rows that own slots into shared memory
//      (coalesced); each thread finds its own split inside the block by the
//      same search, in shared memory, and merges its kPerThread items,
//      writing the block-local row of each slot to shared memory; then the
//      block stores its slots as contiguous runs of each column.  The rows
//      variant stores int4s of 4-slot groups where E % 4 == 0; the decode
//      variant decodes each slot from its row in shared memory and stores
//      16-byte pairs of slots (a warp's store one contiguous 512-byte run)
//      where E is even and the three columns 16-byte aligned; both store
//      scalars at the block's edges.  The decode's tile division is 32-bit
//      wherever the slot's offset in its gaussian fits (always, on keygen's
//      rows).
//
// 512 items a block (128 threads x 4) measured faster at garden30k_1080p
// than 1,024 (256 x 4, 128 x 8): more blocks resident on an SM hide each
// block's chain of dependent loads (partition, scan, columns).
//
// No atomics: the slot order is the scan's, repeat's bit for bit.  Every
// merge position is int64.  The TPU kernel's 512-slot windows,
// scalar-prefetched spans and lane crossbars answered the TPU's DMA and
// gather costs and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kItems = kThreads * kPerThread;  // merged items per block
constexpr int kMaxCols = 7;
constexpr int kPartThreads = 256;

// Merged position of row end i.
__device__ __forceinline__ int64_t row_end_pos(int64_t i, int64_t cum_i, int64_t capacity) {
  return i + (cum_i < capacity ? cum_i : capacity);
}

// part[b] = row ends among the first min(b * kItems, n + capacity) merged
// items, for b in [0, nblocks].
__global__ void __launch_bounds__(kPartThreads)
partition_kernel(const int64_t* __restrict__ cum, int64_t n, int64_t capacity,
                 int64_t nblocks, int64_t* __restrict__ part) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kPartThreads + threadIdx.x;
  if (b > nblocks) return;
  const int64_t items = n + capacity;
  const int64_t d = b * kItems < items ? b * kItems : items;
  int64_t lo = d > capacity ? d - capacity : 0;  // at most E slots precede d
  int64_t hi = d < n ? d : n;
  while (lo < hi) {  // first i with row_end_pos(i) >= d
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (row_end_pos(mid, cum[mid], capacity) < d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  part[b] = lo;
}

// The decode variant's outputs: keygen's sort elements.
struct Elements {
  int64_t* tile;
  int64_t* depth;
  int64_t* index;
  int64_t* count;
  int64_t grid_w;
};

constexpr int kDecodeCols = 6;  // id, offset, max(w, 1), min_x, min_y, depth bits
constexpr int64_t kSentinel = 0xFFFFFFFFll;  // core/config.py SENTINEL

struct Element {
  int64_t tile, depth, index;
};

// Slot j's sort element, from its block-local row r of the staged columns.
__device__ __forceinline__ Element decode(const int32_t (*s_cols)[kItems + 1], int r, int64_t j,
                                          int64_t grid_w) {
  const int64_t local = j - s_cols[1][r];
  const int64_t gw = s_cols[2][r] > 1 ? s_cols[2][r] : 1;
  int64_t ly;
  if (local >= 0 && local <= 0xFFFFFFFFll) {
    ly = static_cast<uint32_t>(local) / static_cast<uint32_t>(gw);
  } else {  // floor division, as torch.div(rounding_mode="floor")
    ly = local / gw;
    if (local % gw != 0 && local < 0) --ly;
  }
  const int64_t lx = local - ly * gw;
  return {(s_cols[4][r] + ly) * grid_w + (s_cols[3][r] + lx),
          static_cast<int64_t>(static_cast<uint32_t>(s_cols[5][r])),
          static_cast<int64_t>(s_cols[0][r])};
}

// kDecode: the decode variant (kDecodeCols columns in, `el` out, `out`
// unused); else the rows variant (`out`, `el` unused).
template <bool kVec, bool kDecode>
__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const int32_t* __restrict__ cols, int ncols,
                   const int64_t* __restrict__ cum, int64_t n, int64_t capacity,
                   const int64_t* __restrict__ part, int32_t* __restrict__ out, Elements el) {
  __shared__ int64_t s_cum[kItems];
  __shared__ int32_t s_cols[kMaxCols][kItems + 1];
  __shared__ int16_t s_row[kItems];

  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kItems;
  const int64_t items = n + capacity;
  const int64_t d1 = d0 + kItems < items ? d0 + kItems : items;
  const int64_t a0 = part[blockIdx.x];
  const int64_t a1 = part[blockIdx.x + 1];
  const int64_t b0 = d0 - a0;
  const int na = static_cast<int>(a1 - a0);        // row ends in this block
  const int nb = static_cast<int>(d1 - a1 - b0);   // slots in this block

  if (kDecode && blockIdx.x == 0 && threadIdx.x == 0) {
    const int64_t total = n > 0 ? cum[n - 1] : 0;
    *el.count = total < capacity ? total : capacity;
  }

  // Local row k is source row a0 + k, for k in [0, na]: row a1 may own the
  // block's last slots.  Only rows with a non-zero count own slots, so only
  // theirs are read; rows >= n are the dead slots' zero rows.
  for (int k = threadIdx.x; k <= na; k += kThreads) {
    const int64_t r = a0 + k;
    bool owns = r < n;
    if (k < na) {
      const int64_t end = cum[r];
      s_cum[k] = end;
      owns = end > (r > 0 ? cum[r - 1] : 0);
    }
    for (int c = 0; c < ncols; ++c) s_cols[c][k] = owns ? cols[c * n + r] : 0;
  }
  __syncthreads();

  // This thread's items [dt, dt + kPerThread) of the block's merge.
  const int dt = min(static_cast<int>(threadIdx.x) * kPerThread, na + nb);
  int lo = max(0, dt - nb);
  int hi = min(dt, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_end_pos(a0 + mid, s_cum[mid], capacity) < d0 + dt) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ai = lo;
  int bi = dt - lo;
  for (int s = 0; s < kPerThread && ai + bi < na + nb; ++s) {
    if (bi >= nb || (ai < na && s_cum[ai] <= b0 + bi)) {
      ++ai;  // row end: the slots after it belong to the next row
    } else {
      s_row[bi++] = static_cast<int16_t>(ai);
    }
  }
  __syncthreads();

  // The block's slots [b0, b0 + nb), each column a contiguous run.
  const int64_t b1 = b0 + nb;
  if (kDecode) {
    // Slots of local rows at or past n - a0 lie past the total: dead.
    const int64_t rows_left = n - a0;
    auto element = [&](int64_t j) -> Element {
      const int r = s_row[j - b0];
      if (r >= rows_left) return {kSentinel, kSentinel, kSentinel};
      return decode(s_cols, r, j, el.grid_w);
    };
    auto store = [&](int64_t j) {
      const Element e = element(j);
      el.tile[j] = e.tile;
      el.depth[j] = e.depth;
      el.index[j] = e.index;
    };
    if (kVec) {
      for (int64_t g = (b0 >> 1) + threadIdx.x; g < (b1 + 1) >> 1; g += kThreads) {
        const int64_t j = g << 1;
        if (j >= b0 && j + 2 <= b1) {
          const Element e0 = element(j), e1 = element(j + 1);
          *reinterpret_cast<longlong2*>(el.tile + j) = make_longlong2(e0.tile, e1.tile);
          *reinterpret_cast<longlong2*>(el.depth + j) = make_longlong2(e0.depth, e1.depth);
          *reinterpret_cast<longlong2*>(el.index + j) = make_longlong2(e0.index, e1.index);
        } else {  // a pair cut by the block's edge
          for (int64_t jj = j > b0 ? j : b0; jj < j + 2 && jj < b1; ++jj) store(jj);
        }
      }
    } else {
      for (int64_t j = b0 + threadIdx.x; j < b1; j += kThreads) store(j);
    }
  } else if (kVec) {
    for (int64_t g = (b0 >> 2) + threadIdx.x; g < (b1 + 3) >> 2; g += kThreads) {
      const int64_t j = g << 2;
      if (j >= b0 && j + 4 <= b1) {
        const int k = static_cast<int>(j - b0);
        const int r0 = s_row[k], r1 = s_row[k + 1], r2 = s_row[k + 2], r3 = s_row[k + 3];
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          if (c < ncols) {
            *reinterpret_cast<int4*>(out + c * capacity + j) =
                make_int4(s_cols[c][r0], s_cols[c][r1], s_cols[c][r2], s_cols[c][r3]);
          }
        }
      } else {  // a group cut by the block's edge
        for (int64_t jj = j > b0 ? j : b0; jj < j + 4 && jj < b1; ++jj) {
          const int r = s_row[jj - b0];
          for (int c = 0; c < ncols; ++c) out[c * capacity + jj] = s_cols[c][r];
        }
      }
    }
  } else {
    for (int k = threadIdx.x; k < nb; k += kThreads) {
      const int r = s_row[k];
      for (int c = 0; c < ncols; ++c) out[c * capacity + b0 + k] = s_cols[c][r];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The partition search, then the expansion in the variant kDecode, with
// 16-byte stores where `vec`.
template <bool kDecode>
cudaError_t expand(const int32_t* cols, int ncols, const int64_t* cum, int64_t n, int64_t capacity,
                   int64_t* part, int64_t nblocks, bool vec, int32_t* out, Elements el,
                   cudaStream_t s) {
  const int64_t part_blocks = (nblocks + 1 + kPartThreads - 1) / kPartThreads;
  partition_kernel<<<static_cast<unsigned int>(part_blocks), kPartThreads, 0, s>>>(
      cum, n, capacity, nblocks, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = vec ? expand_rows_kernel<true, kDecode> : expand_rows_kernel<false, kDecode>;
  kernel<<<static_cast<unsigned int>(nblocks), kThreads, 0, s>>>(cols, ncols, cum, n, capacity,
                                                                 part, out, el);
  return cudaGetLastError();
}

}  // namespace

// part: nblocks + 1 int64 of scratch, nblocks = ceil((n + capacity) / items
// per block).  The output must be 16-byte aligned for the int4 stores.
extern "C" int vk3d_expand_rows(const void* cols, int32_t ncols, const void* cum,
                                int64_t n, int64_t capacity, void* part, int64_t nblocks,
                                void* out, int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (capacity <= 0) return static_cast<int>(cudaSuccess);
  if (ncols < 1 || ncols > kMaxCols || nblocks != (n + capacity + kItems - 1) / kItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = capacity % 4 == 0 && aligned16(out);
  return static_cast<int>(expand<false>(
      static_cast<const int32_t*>(cols), ncols, static_cast<const int64_t*>(cum), n, capacity,
      static_cast<int64_t*>(part), nblocks, vec, static_cast<int32_t*>(out), Elements{},
      static_cast<cudaStream_t>(stream)));
}

// The decode variant over keygen's [6, n] int32 columns: the [capacity]
// int64 tile, depth and index columns and the [] int64 count, which is
// written for capacity == 0 too.  part as vk3d_expand_rows's.
extern "C" int vk3d_expand_elements(const void* cols, const void* cum, int64_t n,
                                    int64_t capacity, int64_t grid_w, void* part, int64_t nblocks,
                                    void* tile, void* depth, void* index, void* count,
                                    int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (capacity < 0 || nblocks != (n + capacity + kItems - 1) / kItems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (capacity == 0) return static_cast<int>(cudaMemsetAsync(count, 0, sizeof(int64_t), s));
  const Elements el{static_cast<int64_t*>(tile), static_cast<int64_t*>(depth),
                    static_cast<int64_t*>(index), static_cast<int64_t*>(count), grid_w};
  const bool vec = capacity % 2 == 0 && aligned16(tile) && aligned16(depth) && aligned16(index);
  return static_cast<int>(expand<true>(
      static_cast<const int32_t*>(cols), kDecodeCols, static_cast<const int64_t*>(cum), n,
      capacity, static_cast<int64_t*>(part), nblocks, vec, nullptr, el, s));
}

extern "C" const char* vk3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
