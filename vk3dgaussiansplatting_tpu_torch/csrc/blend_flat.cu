// Flat tiled blend with the transmittance read-back (K3) — the capped path's
// blend.
//
// Replaces the TPU kernel vk3dgaussiansplatting_tpu/ops/pallas/blend_kernel.py
// : blend_flat_core / blend_tiles_pallas_flat (_blend_flat_kernel).  Same
// per-pixel blend as csrc/blend.cu (K2) over each tile's [start, end) of an
// index array, with an optional cap on the range length and, with_t, the
// per-pixel outgoing transmittance [num_tiles, 256] that the capped policy
// (ops/capped.py) validates tiles and sets caps and thresholds from.
//
// The TPU kernel's T has batch-granular semantics, and the policy compares
// it far below the stop (x0.3, x0.02 of 1e-4), so with_t reproduces them:
// a tile's range is cut into batch_k-element batches starting at
// floor(start/128)*128; within a batch every pixel multiplies T by
// (1 - alpha) over every eligible element, contributing colour only while
// its incoming T >= t_stop; the block leaves only at a batch boundary, once
// all 256 pixels (those past the image edge too: they count in the tile's
// max T) are below the stop.  Without with_t (patch pass, full fallback) it
// is K2's per-pixel early-out, which gives the same image.
//
// What bounds it on the H100: as K2, the pair evaluations (with T, every
// pair of every batch the block enters), and the gather of each element's
// 36-byte frame row by packed gaussian id (the capped layout holds
// ~max(cap, saturation depth) elements per tile).
//
// Design: K2's block of 256 threads per tile and its staging
// (csrc/blend_rows.cuh): each stage's rows are copied with cp.async from
// the frame's screen_pos, cov_inv and color_alpha by id, double-buffered,
// with the ids loaded a stage ahead, so no [N, 10] feature table is built.
// A stage holds at most 256 rows and never crosses a batch boundary (the
// first batch can be short: it starts at `start`).  A pair with f > 0 or
// f < thr is skipped, expf and all: it is ineligible, so it would change
// neither T nor colour.  The arithmetic is written with __fmul_rn/__fadd_rn
// so nothing contracts into an FMA: every operation rounds as the plain
// PyTorch version's separate ops do, so the kernel's T and colour equal it
// bit for bit and the policy decisions from the two agree.  Slots at or
// past num_index and SENTINEL ids are dead (galpha 0), as the TPU kernel's
// zero padding is.

#include <cstdint>
#include <cuda_runtime.h>

#include "blend_rows.cuh"

namespace {

using namespace vk3d;

constexpr int kAlign = 128;

// End of the stage that starts at k0: at most kStage rows, never past the
// batch that holds k0 or the range's end.
__device__ __forceinline__ int64_t stage_end(int64_t k0, int64_t astart, int batch_k,
                                             int64_t end) {
  const int64_t batch_end = astart + ((k0 - astart) / batch_k + 1) * batch_k;
  int64_t e = k0 + kStage < batch_end ? k0 + kStage : batch_end;
  return e < end ? e : end;
}

template <bool kWithT>
__global__ void __launch_bounds__(kThreads)
blend_flat_kernel(const float2* __restrict__ pos, const float* __restrict__ cov,
                  const float4* __restrict__ color, const int64_t* __restrict__ index,
                  int64_t num_index, const int64_t* __restrict__ ranges, int64_t cap,
                  int batch_k, int grid_w, int width, int height, float alpha_cutoff,
                  float t_stop, float* __restrict__ out, float* __restrict__ t_out) {
  __shared__ Batch s_batch[2];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px_i = (tile % grid_w) * kTile + t % kTile;
  const int py_i = (tile / grid_w) * kTile + t / kTile;
  const float px = static_cast<float>(px_i);
  const float py = static_cast<float>(py_i);
  const bool inside = px_i < width && py_i < height;
  const int64_t start = ranges[2 * tile];
  int64_t end = ranges[2 * tile + 1];
  if (cap > 0 && end > start + cap) end = start + cap;
  const int64_t astart = (start / kAlign) * kAlign;
  auto id_at = [&](int64_t k) { return k < num_index ? index[k] : kSentinel; };

  float trans = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = kWithT ? false : !inside;

  // Stages [k0, k1), [k1, k2): the first's rows in flight, the second's ids
  // loaded.
  int64_t k0 = start;
  int64_t k1 = k0 < end ? stage_end(k0, astart, batch_k, end) : end;
  int64_t k2 = k1 < end ? stage_end(k1, astart, batch_k, end) : end;
  if (k0 + t < k1) fetch_frame_row(s_batch[0], t, id_at(k0 + t), pos, cov, color);
  cp_async_commit();
  int64_t next_idx = k1 + t < k2 ? id_at(k1 + t) : kSentinel;

  for (int buf = 0; k0 < end; buf ^= 1) {
    Batch& b = s_batch[buf];
    cp_async_wait_all();  // this thread's copies of stage k0
    if (k0 + t < k1) finish_frame_row(b, t, alpha_cutoff);
    // Barrier: the stage is visible to every pixel, and every pixel is past
    // the previous stage, so its buffer is free.  And the block-wide exit
    // (nothing is in flight here): with T, only where a batch after the
    // first begins, once every pixel is below the stop (the TPU kernel's
    // batch skip); without, once every pixel is done.
    const bool batch_start = k0 != start && (k0 - astart) % batch_k == 0;
    if (!__syncthreads_or(kWithT ? (!batch_start || trans >= t_stop) : !done)) break;
    if (k1 + t < k2) fetch_frame_row(s_batch[buf ^ 1], t, next_idx, pos, cov, color);
    cp_async_commit();
    const int64_t k3 = k2 < end ? stage_end(k2, astart, batch_k, end) : end;
    next_idx = k2 + t < k3 ? id_at(k2 + t) : kSentinel;

    if (!done) {
      const int n = static_cast<int>(k1 - k0);
#pragma unroll 4  // measured faster than 1 and 2 at garden30k_1080p (PERF.md)
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
        if (alpha >= alpha_cutoff) {
          if (trans >= t_stop) {
            const float w = __fmul_rn(trans, alpha);
            cr = __fadd_rn(cr, __fmul_rn(w, c.x));
            cg = __fadd_rn(cg, __fmul_rn(w, c.y));
            cb = __fadd_rn(cb, __fmul_rn(w, c.z));
          }
          trans = __fmul_rn(trans, __fsub_rn(1.0f, alpha));
          if (!kWithT && trans < t_stop) {
            done = true;
            break;
          }
        }
      }
    }
    k0 = k1;
    k1 = k2;
    k2 = k3;
  }
  cp_async_wait_all();  // the last iteration's (empty) group, or none

  if (inside) {
    float* o = out + (static_cast<int64_t>(py_i) * width + px_i) * 3;
    o[0] = fminf(fmaxf(cr, 0.0f), 1.0f);
    o[1] = fminf(fmaxf(cg, 0.0f), 1.0f);
    o[2] = fminf(fmaxf(cb, 0.0f), 1.0f);
  }
  if (kWithT) t_out[static_cast<int64_t>(tile) * kThreads + t] = trans;
}

}  // namespace

// screen_pos [N, 2], cov_inv [N, 3] and color_alpha [N, 4] float32,
// contiguous; color_alpha 16-byte and screen_pos 8-byte aligned.
extern "C" int vk3d_blend_flat(const void* screen_pos, const void* cov_inv,
                               const void* color_alpha, const void* index, int64_t num_index,
                               const void* ranges, int32_t num_tiles, int64_t cap,
                               int32_t batch_k, int32_t grid_w, int32_t width, int32_t height,
                               float alpha_cutoff, float t_stop, void* out, void* t_out,
                               int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(color_alpha) % 16 || reinterpret_cast<uintptr_t>(screen_pos) % 8) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto pos = static_cast<const float2*>(screen_pos);
  auto cov = static_cast<const float*>(cov_inv);
  auto col = static_cast<const float4*>(color_alpha);
  auto ix = static_cast<const int64_t*>(index);
  auto rg = static_cast<const int64_t*>(ranges);
  if (t_out != nullptr) {
    blend_flat_kernel<true><<<num_tiles, kThreads, 0, s>>>(
        pos, cov, col, ix, num_index, rg, cap, batch_k, grid_w, width, height, alpha_cutoff,
        t_stop, static_cast<float*>(out), static_cast<float*>(t_out));
  } else {
    blend_flat_kernel<false><<<num_tiles, kThreads, 0, s>>>(
        pos, cov, col, ix, num_index, rg, cap, batch_k, grid_w, width, height, alpha_cutoff,
        t_stop, static_cast<float*>(out), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
