// Tiled front-to-back alpha blend — the RenderGaussians pass.
//
// Replaces the TPU kernel vk3dgaussiansplatting_tpu/ops/pallas/blend_kernel.py
// : blend_tiles_pallas (_blend_tile_kernel), and the [E, 16] feature
// pre-gather it needs outside the kernel (_build_features).
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
// What bounds it on the H100: pair evaluations (one expf and ~12 flops per
// element per pixel still alive) and the per-element gathers of a 40-byte
// feature row by sorted index (E rows per frame, in scattered order).
//
// Design (the reference's own RenderGaussians shape, SURVEY.md §3.4): one
// block of 256 threads per tile, one thread per pixel.  Each batch of 256
// elements is gathered once into shared memory, one row per thread, and
// then read by all 256 pixels, so a row costs one global gather per tile
// instead of one per pixel.  Each pixel runs the sequential recurrence with
// its own early-out; the block leaves as soon as every pixel is done
// (__syncthreads_or), which is what makes saturated tiles cheap.  Pixels
// outside the image start done.  The TPU kernel's K-lane batches, DMA
// double-buffering and exclusive-cumprod tree are not carried over: the
// recurrence is sequential per thread here, as in the reference.
//
// expf (not __expf), and FMA contraction left at nvcc's default (-fmad=true).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kBatch = kThreads;
constexpr int kCols = 10;  // gx, gy, a', b', c', 0, r, g, b, galpha
constexpr int64_t kSentinel = 0xFFFFFFFFLL;

struct Feature {
  float gx, gy, a, b, c, r, g, bl, galpha;
};

__global__ void __launch_bounds__(kThreads)
blend_tiles_kernel(const float* __restrict__ table, const int64_t* __restrict__ index,
                   const int64_t* __restrict__ ranges, int grid_w, int width,
                   int height, float alpha_cutoff, float t_stop,
                   float* __restrict__ out) {
  __shared__ Feature s_feat[kBatch];

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

  for (int64_t k0 = start; k0 < end; k0 += kBatch) {
    // Barrier for the previous batch's readers, and the block-wide exit.
    if (!__syncthreads_or(!done)) break;
    const int n = static_cast<int>(end - k0 < kBatch ? end - k0 : kBatch);
    if (t < n) {
      const int64_t idx = index[k0 + t];
      Feature ft{};
      if (idx != kSentinel) {
        const float* row = table + idx * kCols;
        ft.gx = row[0];
        ft.gy = row[1];
        ft.a = row[2];
        ft.b = row[3];
        ft.c = row[4];
        ft.r = row[6];
        ft.g = row[7];
        ft.bl = row[8];
        ft.galpha = row[9];
      }
      s_feat[t] = ft;
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const Feature ft = s_feat[j];
      const float dx = ft.gx - px;
      const float dy = py - ft.gy;
      const float f = (ft.a * dx * dx + ft.c * dy * dy) + ft.b * dx * dy;
      const float alpha = ft.galpha * expf(f);
      if (f <= 0.0f && alpha >= alpha_cutoff) {
        const float w = trans * alpha;
        cr += w * ft.r;
        cg += w * ft.g;
        cb += w * ft.bl;
        trans *= 1.0f - alpha;
        if (trans < t_stop) {
          done = true;
          break;
        }
      }
    }
  }

  if (px_i < width && py_i < height) {
    float* o = out + (static_cast<int64_t>(py_i) * width + px_i) * 3;
    o[0] = fminf(fmaxf(cr, 0.0f), 1.0f);
    o[1] = fminf(fmaxf(cg, 0.0f), 1.0f);
    o[2] = fminf(fmaxf(cb, 0.0f), 1.0f);
  }
}

}  // namespace

extern "C" int vk3d_blend_tiles(const void* table, const void* index, const void* ranges,
                                int32_t num_tiles, int32_t grid_w, int32_t width,
                                int32_t height, float alpha_cutoff, float t_stop,
                                void* out, int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  blend_tiles_kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int64_t*>(index),
      static_cast<const int64_t*>(ranges), grid_w, width, height, alpha_cutoff, t_stop,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
