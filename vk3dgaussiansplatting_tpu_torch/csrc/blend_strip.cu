// Carry-aware strip blend (K4) — the distributed frame's per-phase blend.
//
// Replaces the TPU kernel vk3dgaussiansplatting_tpu/ops/pallas/blend_kernel.py
// : blend_strip_colors_pallas (_blend_tile_kernel with with_carry=True).  In
// phase s of the systolic blend (parallel/dist.py), a rank blends its depth
// band of every tile of one strip, starting from the (colour, log T) carry
// that the rank holding the band in front of it passed on.
//
// Per strip tile i (global tile tile_base + i, which gives the pixel
// coordinates): T starts at expf(carry_logt) and the colour at carry_color;
// each pixel runs over the tile's [start, end) of the slots, adding
// T * alpha * rgb and multiplying T by (1 - alpha) for every eligible
// element, and stops once T < t_stop, as K2's pixels do; a pixel whose
// carry is already below the stop does nothing.  Out: the unclipped colour
// [T_s, 256, 3] and logf(T) at the pixel's stop (or end) [T_s, 256].
//
// Against the plain version (ops/blend.py:blend_strip_plain, the TPU
// kernel's batch-granular T: a pixel below the stop keeps multiplying T to
// the end of the batch, and a tile stops only at a batch boundary): the
// colour is the same bit for bit, since neither adds colour once T is below
// the stop and T never rises again (alpha <= galpha <= 1, galpha a sigmoid);
// log T is the same bit for bit wherever the plain T >= t_stop; elsewhere
// both T are below t_stop (so both logf(T) are at most logf(t_stop): a T
// just under the stop can round to it).  That is all a consumer reads: the
// next phase's carry and the last phase's discarded T only decide whether
// a pixel is below the stop.
//
// Rows: with gather == 0, slot k's row is rows[k] (the exchange routed each
// element's pack_feature_table row with it, so they lie in sorted order);
// with gather != 0 it is rows[index[k]], a per-gaussian table.  Slots at or
// past num_slots and SENTINEL ids are dead (galpha 0, as the TPU kernel's
// zeroed padding): their rows are never read.
//
// What bounds it on the H100: as K2, the pair evaluations each pixel needs
// up to its stop; a strip holds 1/world of the tiles and each rank one depth
// band of them, so a phase's grid is T_s blocks.
//
// Design: K2's block of 256 threads per tile and its staging
// (csrc/blend_rows.cuh): the 40-byte rows, already scaled, are copied with
// cp.async in five 8-byte pieces (a row at 40*k bytes is not always 16-byte
// aligned), double-buffered, with the slot ids loaded a stage ahead in both
// modes (the id decides whether the row is dead, and in gather mode where it
// lies), so no row copy waits on an id load.  The block leaves at any stage
// once every pixel has stopped; a tile whose carry is saturated copies
// nothing.  A pair with f > 0 or f < thr is
// skipped, expf and all: it is ineligible.  The arithmetic is written with
// __fmul_rn/__fadd_rn (no FMA contraction) and expf/logf, as torch's
// separate ops round, so the colours equal the plain version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "blend_rows.cuh"

namespace {

using namespace vk3d;

constexpr int kCols = 10;  // gx, gy, a', b', c', 0, r, g, b, galpha

__global__ void __launch_bounds__(kThreads)
blend_strip_kernel(const float* __restrict__ rows, const int64_t* __restrict__ index,
                   int64_t num_slots, int gather, const int64_t* __restrict__ ranges,
                   int tile_base, int grid_w, float alpha_cutoff, float t_stop,
                   const float* __restrict__ carry_color, const float* __restrict__ carry_logt,
                   float* __restrict__ out_color, float* __restrict__ out_logt) {
  __shared__ Batch s_batch[2];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int tile_glob = tile_base + tile;
  const float px = static_cast<float>((tile_glob % grid_w) * kTile + t % kTile);
  const float py = static_cast<float>((tile_glob / grid_w) * kTile + t / kTile);
  const int64_t start = ranges[2 * tile];
  const int64_t pix = static_cast<int64_t>(tile) * kThreads + t;
  auto id_at = [&](int64_t k) { return k < num_slots ? index[k] : kSentinel; };
  auto fetch = [&](Batch& b, int64_t k, int64_t idx) {
    if (idx == kSentinel) {
      zero_row(b, t);
    } else {
      fetch_packed_row(b, t, rows + (gather ? idx : k) * kCols);
    }
  };

  float trans = expf(carry_logt[pix]);
  float cr = carry_color[3 * pix];
  float cg = carry_color[3 * pix + 1];
  float cb = carry_color[3 * pix + 2];
  bool done = !(trans >= t_stop);
  // A tile whose every pixel arrives below the stop passes its carry on.
  const int64_t end = __syncthreads_or(!done) ? ranges[2 * tile + 1] : start;

  // Stage 0's rows in flight, stage 1's ids loaded.
  if (start + t < end) fetch(s_batch[0], start + t, id_at(start + t));
  cp_async_commit();
  int64_t next_idx = start + kStage + t < end ? id_at(start + kStage + t) : kSentinel;

  int buf = 0;
  for (int64_t k0 = start; k0 < end; k0 += kStage, buf ^= 1) {
    Batch& b = s_batch[buf];
    cp_async_wait_all();  // this thread's copies of stage k0
    if (k0 + t < end) set_threshold(b, t, alpha_cutoff);
    // Barrier: the stage is visible to every pixel and the other buffer is
    // free; and the block-wide exit once every pixel has stopped (nothing
    // is in flight here).
    if (!__syncthreads_or(!done)) break;
    const int64_t k1 = k0 + kStage;
    if (k1 + t < end) fetch(s_batch[buf ^ 1], k1 + t, next_idx);
    cp_async_commit();
    next_idx = k1 + kStage + t < end ? id_at(k1 + kStage + t) : kSentinel;
    if (done) continue;

    const int n = static_cast<int>(end - k0 < kStage ? end - k0 : kStage);
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 g = b.geo[j];
      const float2 g2 = b.geo2[j];
      const float dx = __fsub_rn(g.x, px);
      const float dy = __fsub_rn(py, g.y);
      const float f = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(g.z, dx), dx), __fmul_rn(__fmul_rn(g2.x, dy), dy)),
          __fmul_rn(__fmul_rn(g.w, dx), dy));
      if (!(f <= 0.0f && f >= g2.y)) continue;  // ineligible: skipped
      const float4 c = b.color[j];
      const float alpha = __fmul_rn(c.w, expf(f));
      if (alpha >= alpha_cutoff) {  // T >= t_stop here: the pixel is not done
        const float w = __fmul_rn(trans, alpha);
        cr = __fadd_rn(cr, __fmul_rn(w, c.x));
        cg = __fadd_rn(cg, __fmul_rn(w, c.y));
        cb = __fadd_rn(cb, __fmul_rn(w, c.z));
        trans = __fmul_rn(trans, __fsub_rn(1.0f, alpha));
        if (trans < t_stop) {
          done = true;
          break;
        }
      }
    }
  }
  cp_async_wait_all();  // the last iteration's (empty) group, or none

  out_color[3 * pix] = cr;
  out_color[3 * pix + 1] = cg;
  out_color[3 * pix + 2] = cb;
  out_logt[pix] = logf(trans);
}

}  // namespace

// rows 8-byte aligned ([E, 10] or [N, 10] float32, contiguous).
extern "C" int vk3d_blend_strip(const void* rows, const void* index, int64_t num_slots,
                                int32_t gather, const void* ranges, int32_t num_tiles,
                                int32_t tile_base, int32_t grid_w, float alpha_cutoff,
                                float t_stop, const void* carry_color, const void* carry_logt,
                                void* out_color, void* out_logt, int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(rows) % 8) return static_cast<int>(cudaErrorMisalignedAddress);
  blend_strip_kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int64_t*>(index), num_slots, gather,
      static_cast<const int64_t*>(ranges), tile_base, grid_w, alpha_cutoff, t_stop,
      static_cast<const float*>(carry_color), static_cast<const float*>(carry_logt),
      static_cast<float*>(out_color), static_cast<float*>(out_logt));
  return static_cast<int>(cudaGetLastError());
}
