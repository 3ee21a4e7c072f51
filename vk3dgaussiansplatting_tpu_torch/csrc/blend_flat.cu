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
// What bounds it on the H100: as K2, pair evaluations and the gather of a
// 40-byte row per element, here by packed gaussian id (the capped layout
// holds ~max(cap, saturation depth) elements per tile).
//
// Design: K2's block of 256 threads per tile, rows staged through shared
// memory 256 at a time (stages never cross a batch boundary).  The
// arithmetic is written with __fmul_rn/__fadd_rn so nothing contracts into
// an FMA: every operation rounds as the plain PyTorch version's separate
// ops do, so the kernel's T and colour can be held to it bit for bit and
// the policy decisions from the two agree.  Slots at or past num_index and
// SENTINEL ids are dead (galpha 0), as the TPU kernel's zero padding is.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kStage = kThreads;
constexpr int kAlign = 128;
constexpr int kCols = 10;  // gx, gy, a', b', c', 0, r, g, b, galpha
constexpr int64_t kSentinel = 0xFFFFFFFFLL;

struct Feature {
  float gx, gy, a, b, c, r, g, bl, galpha;
};

template <bool kWithT>
__global__ void __launch_bounds__(kThreads)
blend_flat_kernel(const float* __restrict__ table, const int64_t* __restrict__ index,
                  int64_t num_index, const int64_t* __restrict__ ranges, int64_t cap,
                  int batch_k, int grid_w, int width, int height, float alpha_cutoff,
                  float t_stop, float* __restrict__ out, float* __restrict__ t_out) {
  __shared__ Feature s_feat[kStage];

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

  float trans = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = kWithT ? false : !inside;
  bool leave = false;

  for (int64_t b0 = astart; b0 < end && !leave; b0 += batch_k) {
    // The TPU kernel's batch skip: once every pixel is below the stop.
    if (kWithT && b0 != astart && !__syncthreads_or(trans >= t_stop)) break;
    const int64_t lo = b0 > start ? b0 : start;
    const int64_t hi = b0 + batch_k < end ? b0 + batch_k : end;
    for (int64_t k0 = lo; k0 < hi; k0 += kStage) {
      // Barrier for the previous stage's readers, and K2's block exit.
      if (!__syncthreads_or(!done)) {
        leave = true;
        break;
      }
      const int n = static_cast<int>(hi - k0 < kStage ? hi - k0 : kStage);
      if (t < n) {
        Feature ft{};
        const int64_t k = k0 + t;
        const int64_t idx = k < num_index ? index[k] : kSentinel;
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
        const float dx = __fsub_rn(ft.gx, px);
        const float dy = __fsub_rn(py, ft.gy);
        const float f = __fadd_rn(
            __fadd_rn(__fmul_rn(__fmul_rn(ft.a, dx), dx), __fmul_rn(__fmul_rn(ft.c, dy), dy)),
            __fmul_rn(__fmul_rn(ft.b, dx), dy));
        const float alpha = __fmul_rn(ft.galpha, expf(f));
        if (f <= 0.0f && alpha >= alpha_cutoff) {
          if (trans >= t_stop) {
            const float w = __fmul_rn(trans, alpha);
            cr = __fadd_rn(cr, __fmul_rn(w, ft.r));
            cg = __fadd_rn(cg, __fmul_rn(w, ft.g));
            cb = __fadd_rn(cb, __fmul_rn(w, ft.bl));
          }
          trans = __fmul_rn(trans, __fsub_rn(1.0f, alpha));
          if (!kWithT && trans < t_stop) {
            done = true;
            break;
          }
        }
      }
    }
  }

  if (inside) {
    float* o = out + (static_cast<int64_t>(py_i) * width + px_i) * 3;
    o[0] = fminf(fmaxf(cr, 0.0f), 1.0f);
    o[1] = fminf(fmaxf(cg, 0.0f), 1.0f);
    o[2] = fminf(fmaxf(cb, 0.0f), 1.0f);
  }
  if (kWithT) t_out[static_cast<int64_t>(tile) * kThreads + t] = trans;
}

}  // namespace

extern "C" int vk3d_blend_flat(const void* table, const void* index, int64_t num_index,
                               const void* ranges, int32_t num_tiles, int64_t cap,
                               int32_t batch_k, int32_t grid_w, int32_t width, int32_t height,
                               float alpha_cutoff, float t_stop, void* out, void* t_out,
                               int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const float*>(table);
  auto ix = static_cast<const int64_t*>(index);
  auto rg = static_cast<const int64_t*>(ranges);
  if (t_out != nullptr) {
    blend_flat_kernel<true><<<num_tiles, kThreads, 0, s>>>(
        tb, ix, num_index, rg, cap, batch_k, grid_w, width, height, alpha_cutoff, t_stop,
        static_cast<float*>(out), static_cast<float*>(t_out));
  } else {
    blend_flat_kernel<false><<<num_tiles, kThreads, 0, s>>>(
        tb, ix, num_index, rg, cap, batch_k, grid_w, width, height, alpha_cutoff, t_stop,
        static_cast<float*>(out), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
