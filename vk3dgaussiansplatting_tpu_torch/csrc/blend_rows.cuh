// Row staging shared by the tiled blends: K2 (csrc/blend.cu), K3
// (csrc/blend_flat.cu) and K4 (csrc/blend_strip.cu).
//
// A blend block (one 16x16 tile, one pixel a thread) walks its elements in
// stages of 256 rows; each thread copies one row of a stage into shared
// memory with cp.async, packed for the pair loop as
//     geo   = gx, gy, a', b'     geo2 = c', skip threshold
//     color = r, g, b, galpha
// (a' = -a/2, b' = -b, c' = -c/2: f = a'dx^2 + c'dy^2 + b'dxdy).  The rows
// come either from the frame's own tensors by gaussian id (fetch_frame_row:
// screen_pos float2, cov_inv three floats, color_alpha float4; the conic is
// scaled after the copy lands) or from pack_feature_table's 40-byte rows
// [gx, gy, a', b', c', 0, r, g, b, galpha], already scaled (fetch_packed_row,
// five 8-byte copies: a row at 40*k bytes is 8-byte but not always 16-byte
// aligned).  A dead slot (SENTINEL id) is a zero row, written directly:
// galpha 0, so never eligible.
//
// Once its copies have landed (cp_async_wait_all), the copying thread sets
// the row's skip threshold thr = logf(cutoff / galpha) - 1e-3 before the
// stage's barrier.  A pair with f > 0 or f < thr is ineligible: below thr,
// galpha * expf(f) is under the cutoff by a margin far above expf's and
// logf's few-ulp errors (tests/test_torch_blend_redesign.py sweeps it), so a
// blend may skip such a pair, expf and all, without changing its result.
// NaN f or thr skip too: such a pair's alpha is NaN or <= 0, ineligible as
// well.  A dead row's thr is +inf.
//
// Only the staging is shared: K2's pair loop contracts FMAs, K3's and K4's
// are written with __fmul_rn/__fadd_rn so they equal their plain versions
// bit for bit.
//
// K2 also sets each row's warp mask as it lands (warp_mask) and has each
// warp walk only its rows of the stage (compact_warp_rows).  K2's warp w
// holds an 8x4 block of the tile's pixels (warp_pixel); bit w of a row's
// mask is clear only when f < thr at all 32 of the warp's pixels, so the
// warp skips nothing but pairs its loop would skip (ops/blend.py:
// warp_masks_plain is the plain version).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vk3d {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // one pixel a thread
constexpr int kStage = kThreads;         // rows a stage, one copied a thread
constexpr int kWarps = kThreads / 32;   // K2's warps, 8x4 pixels each
constexpr int64_t kSentinel = 0xFFFFFFFFLL;
constexpr float kSkipMargin = 1e-3f;
constexpr uint32_t kAllWarps = (1u << kWarps) - 1;
// warp_mask's outward margin, relative to the size of f's terms, and the
// least |a'| it tests.
constexpr float kMaskMargin = 1.0f / 65536.0f;
constexpr float kMinConic = 1e-30f;

// One stage of rows in shared memory.
struct Batch {
  float4 geo[kStage];    // gx, gy, a', b'
  float2 geo2[kStage];   // c', skip threshold
  float4 color[kStage];  // r, g, b, galpha
};

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(kBytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void zero_row(Batch& b, int s) {
  b.geo[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  b.geo2[s] = make_float2(0.0f, 0.0f);
  b.color[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Start the copies of gaussian idx's frame row into slot s (its conic still
// unscaled: finish_frame_row), or write a dead slot's zero row.
__device__ __forceinline__ void fetch_frame_row(Batch& b, int s, int64_t idx,
                                                const float2* __restrict__ pos,
                                                const float* __restrict__ cov,
                                                const float4* __restrict__ color) {
  if (idx == kSentinel) {
    zero_row(b, s);
    return;
  }
  cp_async<8>(&b.geo[s], pos + idx);
  cp_async<4>(&b.geo[s].z, cov + 3 * idx);
  cp_async<4>(&b.geo[s].w, cov + 3 * idx + 1);
  cp_async<4>(&b.geo2[s].x, cov + 3 * idx + 2);
  cp_async<16>(&b.color[s], color + idx);
}

// Start the copies of one pack_feature_table row (8-byte aligned) into
// slot s; its c' column's neighbour, the 0, lands where thr goes.
__device__ __forceinline__ void fetch_packed_row(Batch& b, int s, const float* __restrict__ row) {
  cp_async<8>(&b.geo[s], row);          // gx, gy
  cp_async<8>(&b.geo[s].z, row + 2);    // a', b'
  cp_async<8>(&b.geo2[s], row + 4);     // c', 0
  cp_async<8>(&b.color[s], row + 6);    // r, g
  cp_async<8>(&b.color[s].z, row + 8);  // b, galpha
}

__device__ __forceinline__ void set_threshold(Batch& b, int s, float alpha_cutoff) {
  b.geo2[s].y = logf(alpha_cutoff / b.color[s].w) - kSkipMargin;
}

// After this thread's copies of slot s have landed: scale a frame row's
// conic by the exact powers of two -0.5, -1, -0.5 (pack_feature_table's
// multiplies, the same bits) and set its skip threshold.
__device__ __forceinline__ void finish_frame_row(Batch& b, int s, float alpha_cutoff) {
  b.geo[s].z *= -0.5f;
  b.geo[s].w *= -1.0f;
  b.geo2[s].x *= -0.5f;
  set_threshold(b, s, alpha_cutoff);
}

// K2's pixel (column, row) of thread t in its tile: warp w = t / 32 covers
// columns 8(w % 2) .. 8(w % 2) + 7 and rows 4(w / 2) .. 4(w / 2) + 3, lane
// l its column l % 8 and row l / 8 there.  An 8x4 block meets fewer rows
// than two 16-pixel rows do.  (K3 and K4 keep pixel t % 16, t / 16.)
__device__ __forceinline__ int2 warp_pixel(int t) {
  const int w = t / 32, l = t % 32;
  return make_int2((w % 2) * 8 + l % 8, (w / 2) * 4 + l / 8);
}

// The maximum of f at dy = e over dx in [lo, hi], from v = kx * e
// (kx = -b'/(2a')), b'e and c'e^2: a concave quadratic in dx, largest at
// its vertex v clamped to the range.
__device__ __forceinline__ float seg_peak(float a, float v, float be, float ce2, float lo,
                                          float hi) {
  const float dx = fminf(fmaxf(v, lo), hi);
  return (a * dx + be) * dx + ce2;
}

// Row s's warp mask in the tile whose first pixel is (x0, y0); its
// threshold is set (finish_frame_row).  Bit w is set unless f < thr at
// every pixel of warp w: the largest seg_peak over its four pixel rows'
// eight columns is below thr, less an outward margin.
//
// The kernel's f at a pixel and each seg_peak lie within a few float32
// ulps of S = |a'|X^2 + |b'|XY + |c'|Y^2 (X, Y the largest |dx| and |dy|
// over the tile) of the exact values; the margin, S / 2^16, is hundreds of
// times those errors, so a cleared bit never hides a pair with f >= thr.
// The vertex takes the fast division (a few ulps, which move the peak by
// far less), in its range: |a'| >= kMinConic, and |a'| < 2^126 where the
// margin is finite.  thr > 0 (a dead row's +inf among them) leaves no pair
// with thr <= f <= 0: no bit.  A conic that is not negative definite
// (a' >= 0, c' >= 0 or 4a'c' <= b'^2), with |a'| < kMinConic, or a margin
// out of float range (which any non-finite value of the row gives: X, Y
// >= 7.5) keep every bit.
__device__ __forceinline__ uint32_t warp_mask(const Batch& bt, int s, float x0, float y0) {
  const float4 g = bt.geo[s];
  const float2 g2 = bt.geo2[s];
  const float a = g.z, b = g.w, c = g2.x, thr = g2.y;
  if (thr > 0.0f) return 0u;
  if (!(a < -kMinConic && c < 0.0f && 4.0f * a * c > b * b)) return kAllWarps;
  const float lo = g.x - (x0 + 15.0f), hi = g.x - x0;  // dx over the columns
  const float mx = fmaxf(fabsf(lo), fabsf(hi));
  const float my = fmaxf(fabsf(y0 - g.y), fabsf((y0 + 15.0f) - g.y));
  const float lim = thr - kMaskMargin * ((fabsf(b) * my - a * mx) * mx - c * my * my);
  if (!(lim > -1e30f)) return kAllWarps;  // also any non-finite value of the row
  const float kx = __fdividef(-0.5f * b, a);
  const float mid_l = g.x - (x0 + 7.0f), mid_r = g.x - (x0 + 8.0f);  // the halves' inner dx
  uint32_t mask = 0;
#pragma unroll
  for (int band = 0; band < kWarps / 2; ++band) {  // warps 2 band (left), 2 band + 1
    float left = 0.0f, right = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = (y0 + static_cast<float>(4 * band + r)) - g.y;
      const float v = kx * e, be = b * e, ce2 = c * e * e;
      const float pl = seg_peak(a, v, be, ce2, mid_l, hi);
      const float pr = seg_peak(a, v, be, ce2, lo, mid_r);
      left = r == 0 ? pl : fmaxf(left, pl);
      right = r == 0 ? pr : fmaxf(right, pr);
    }
    if (!(left < lim)) mask |= 1u << (2 * band);
    if (!(right < lim)) mask |= 1u << (2 * band + 1);
  }
  return mask;
}

// Warp `warp`'s rows of a stage of n rows, in order: the rows whose mask
// has bit `warp` set, as row numbers into `list`.  Called by all 32 lanes;
// returns the count.
__device__ __forceinline__ int compact_warp_rows(const uint8_t* __restrict__ masks, int n,
                                                 int warp, int lane, uint8_t* __restrict__ list) {
  int count = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int j = c0 + lane;
    const bool take = j < n && ((masks[j] >> warp) & 1u);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, take);
    if (take) list[count + __popc(ballot & ((1u << lane) - 1u))] = static_cast<uint8_t>(j);
    count += __popc(ballot);
  }
  __syncwarp();
  return count;
}

}  // namespace vk3d
