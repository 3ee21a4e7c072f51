// Tiled front-to-back alpha blend — the RenderGaussians pass.
//
// Replaces the TPU entry point vk3dgaussiansplatting_tpu/ops/pallas/
// blend_kernel.py : blend_tiles_pallas (_blend_tile_kernel) together with
// the feature build it runs inside the call (_build_features,
// pack_feature_table): the kernel reads each element's row of the frame
// data itself, so no [N, 10] table is written and read back.
//
// Per 16x16 screen tile, per pixel p = v*16 + u, over the tile's sorted
// element range [start, end):
//     f     = a'dx^2 + c'dy^2 + b'dxdy   (a' = -a/2, b' = -b, c' = -c/2,
//             dx = gx - px, dy = py - gy: RenderGaussians.comp:117-124)
//     alpha = galpha * exp(f)
//     if f <= 0 and alpha >= 1/255:  color += T*alpha*rgb; T *= 1 - alpha
//     stop the pixel once T < 1e-4
// and the clipped rgb is stored straight into the [H, W, 3] image, edge
// tiles cropped.
//
// What bounds it on the H100: the pair evaluations, about 20 flops and one
// expf per (pixel, element) pair a pixel still needs; the bytes (each live
// element's 8-byte id and its gaussian's 36-byte row, read once) are a
// fraction of that at the stand-in scenes.
//
// Design (the reference's RenderGaussians shape, SURVEY.md §3.4): one block
// per tile, the sequential per-pixel recurrence with its own early-out, and
// the block leaves as soon as every pixel is done (__syncthreads_or), which
// is what makes saturated tiles cheap.  Each batch of 256 elements is copied
// once into shared memory and read by every pixel.
// - The copies are cp.async from the frame's own tensors into packed rows
//   (csrc/blend_rows.cuh), double-buffered: the next batch's rows are in
//   flight while the current batch is blended, and the ids of the batch
//   after that are loaded a batch ahead, so the id -> row dependency stays
//   off the critical path.
// - A pair is skipped, expf and all, when f > 0 or f < thr (the row's skip
//   threshold, blend_rows.cuh): such a pair is ineligible, so the result
//   cannot change.
// - One pixel a thread: two pixels a thread (one shared row read for two
//   pairs) measured slower at garden30k_1080p (PERF.md, K2 findings).
//
// expf (not __expf), and FMA contraction left at nvcc's default (-fmad=true).

#include <cstdint>
#include <cuda_runtime.h>

#include "blend_rows.cuh"

namespace {

using namespace vk3d;

__global__ void __launch_bounds__(kThreads)
blend_tiles_kernel(const float2* __restrict__ pos, const float* __restrict__ cov,
                   const float4* __restrict__ color, const int64_t* __restrict__ index,
                   const int64_t* __restrict__ ranges, int grid_w, int width, int height,
                   float alpha_cutoff, float t_stop, float* __restrict__ out) {
  __shared__ Batch s_batch[2];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px_i = (tile % grid_w) * kTile + t % kTile;
  const int py_i = (tile / grid_w) * kTile + t / kTile;
  const float px = static_cast<float>(px_i);
  const float py = static_cast<float>(py_i);
  const int64_t start = ranges[2 * tile];
  const int64_t end = ranges[2 * tile + 1];

  float trans = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = px_i >= width || py_i >= height;

  // Batch 0's rows in flight, batch 1's id loaded.
  if (start + t < end) fetch_frame_row(s_batch[0], t, index[start + t], pos, cov, color);
  cp_async_commit();
  int64_t next_idx = start + kStage + t < end ? index[start + kStage + t] : kSentinel;

  int buf = 0;
  for (int64_t k0 = start; k0 < end; k0 += kStage, buf ^= 1) {
    Batch& b = s_batch[buf];
    cp_async_wait_all();  // this thread's copies of batch k0
    if (k0 + t < end) finish_frame_row(b, t, alpha_cutoff);
    // Barrier: the batch is visible to every pixel, and every pixel is past
    // the previous batch, so its buffer is free; and the block-wide exit
    // (nothing is in flight here).
    if (!__syncthreads_or(!done)) break;
    const int64_t k1 = k0 + kStage;
    if (k1 + t < end) fetch_frame_row(s_batch[buf ^ 1], t, next_idx, pos, cov, color);
    cp_async_commit();
    next_idx = k1 + kStage + t < end ? index[k1 + kStage + t] : kSentinel;
    if (done) continue;

    const int n = static_cast<int>(end - k0 < kStage ? end - k0 : kStage);
#pragma unroll 2  // measured faster than 1 and 4 at garden30k_1080p
    for (int j = 0; j < n; ++j) {
      const float4 g = b.geo[j];
      const float2 g2 = b.geo2[j];
      const float dx = g.x - px;
      const float dy = py - g.y;
      const float f = (g.z * dx * dx + g2.x * dy * dy) + g.w * dx * dy;
      if (!(f <= 0.0f && f >= g2.y)) continue;  // ineligible: skipped
      const float4 c = b.color[j];
      const float alpha = c.w * expf(f);
      if (alpha >= alpha_cutoff) {
        const float w = trans * alpha;
        cr += w * c.x;
        cg += w * c.y;
        cb += w * c.z;
        trans *= 1.0f - alpha;
        if (trans < t_stop) {
          done = true;
          break;
        }
      }
    }
  }
  cp_async_wait_all();  // the last iteration's (empty) group, or none

  if (px_i < width && py_i < height) {
    float* o = out + (static_cast<int64_t>(py_i) * width + px_i) * 3;
    o[0] = fminf(fmaxf(cr, 0.0f), 1.0f);
    o[1] = fminf(fmaxf(cg, 0.0f), 1.0f);
    o[2] = fminf(fmaxf(cb, 0.0f), 1.0f);
  }
}

}  // namespace

// screen_pos [N, 2], cov_inv [N, 3] and color_alpha [N, 4] float32,
// contiguous; color_alpha 16-byte and screen_pos 8-byte aligned.
extern "C" int vk3d_blend_tiles(const void* screen_pos, const void* cov_inv,
                                const void* color_alpha, const void* index, const void* ranges,
                                int32_t num_tiles, int32_t grid_w, int32_t width, int32_t height,
                                float alpha_cutoff, float t_stop, void* out, int32_t device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  if (reinterpret_cast<uintptr_t>(color_alpha) % 16 || reinterpret_cast<uintptr_t>(screen_pos) % 8) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  blend_tiles_kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(screen_pos), static_cast<const float*>(cov_inv),
      static_cast<const float4*>(color_alpha), static_cast<const int64_t*>(index),
      static_cast<const int64_t*>(ranges), grid_w, width, height, alpha_cutoff, t_stop,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
