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
// the tile's [start, end) of the slots is cut into batch_k-element batches
// starting at floor(start/128)*128, as in K3 (csrc/blend_flat.cu); within a
// batch every pixel multiplies T by (1 - alpha) over every eligible element,
// adding colour only while its incoming T >= t_stop; before every batch, the
// first included, the block leaves once all 256 pixels (those past the image
// edge too) are below the stop, so a saturated carry passes through
// untouched.  Out: the unclipped colour [T_s, 256, 3] and logf(T) [T_s, 256].
//
// Rows: with gather == 0, slot k's row is rows[k] (the exchange routed each
// element's features with it, so they lie in sorted order); with gather != 0
// it is rows[index[k]], a per-gaussian table.  Slots at or past num_slots and
// SENTINEL ids are dead (galpha 0, as the TPU kernel's zeroed padding).
//
// What bounds it on the H100: as K3, pair evaluations and a 40-byte row read
// per element; a strip holds 1/world of the tiles and each rank one depth
// band of them, so a phase's grid is T_s blocks.
//
// Design: K3's block of 256 threads per tile with rows staged through shared
// memory 256 at a time, stages never crossing a batch boundary, and the
// arithmetic written with __fmul_rn/__fadd_rn (no FMA contraction) and
// expf/logf, so the kernel equals its plain PyTorch version bit for bit.

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

__global__ void __launch_bounds__(kThreads)
blend_strip_kernel(const float* __restrict__ rows, const int64_t* __restrict__ index,
                   int64_t num_slots, int gather, const int64_t* __restrict__ ranges,
                   int tile_base, int batch_k, int grid_w, float alpha_cutoff, float t_stop,
                   const float* __restrict__ carry_color, const float* __restrict__ carry_logt,
                   float* __restrict__ out_color, float* __restrict__ out_logt) {
  __shared__ Feature s_feat[kStage];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int tile_glob = tile_base + tile;
  const float px = static_cast<float>((tile_glob % grid_w) * kTile + t % kTile);
  const float py = static_cast<float>((tile_glob / grid_w) * kTile + t / kTile);
  const int64_t start = ranges[2 * tile];
  const int64_t end = ranges[2 * tile + 1];
  const int64_t astart = (start / kAlign) * kAlign;
  const int64_t pix = static_cast<int64_t>(tile) * kThreads + t;

  float trans = expf(carry_logt[pix]);
  float cr = carry_color[3 * pix];
  float cg = carry_color[3 * pix + 1];
  float cb = carry_color[3 * pix + 2];

  for (int64_t b0 = astart; b0 < end; b0 += batch_k) {
    // The TPU kernel's loop condition: the block stops once every pixel is
    // below the stop (a barrier too, for the previous stage's readers).
    if (!__syncthreads_or(trans >= t_stop)) break;
    const int64_t lo = b0 > start ? b0 : start;
    const int64_t hi = b0 + batch_k < end ? b0 + batch_k : end;
    for (int64_t k0 = lo; k0 < hi; k0 += kStage) {
      if (k0 != lo) __syncthreads();  // the previous stage's readers
      const int n = static_cast<int>(hi - k0 < kStage ? hi - k0 : kStage);
      if (t < n) {
        Feature ft{};
        const int64_t k = k0 + t;
        const int64_t idx = k < num_slots ? index[k] : kSentinel;
        if (idx != kSentinel) {
          const float* row = rows + (gather ? idx : k) * kCols;
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
        }
      }
    }
  }

  out_color[3 * pix] = cr;
  out_color[3 * pix + 1] = cg;
  out_color[3 * pix + 2] = cb;
  out_logt[pix] = logf(trans);
}

}  // namespace

extern "C" int vk3d_blend_strip(const void* rows, const void* index, int64_t num_slots,
                                int32_t gather, const void* ranges, int32_t num_tiles,
                                int32_t tile_base, int32_t batch_k, int32_t grid_w,
                                float alpha_cutoff, float t_stop, const void* carry_color,
                                const void* carry_logt, void* out_color, void* out_logt,
                                int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  blend_strip_kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int64_t*>(index), num_slots, gather,
      static_cast<const int64_t*>(ranges), tile_base, batch_k, grid_w, alpha_cutoff, t_stop,
      static_cast<const float*>(carry_color), static_cast<const float*>(carry_logt),
      static_cast<float*>(out_color), static_cast<float*>(out_logt));
  return static_cast<int>(cudaGetLastError());
}
