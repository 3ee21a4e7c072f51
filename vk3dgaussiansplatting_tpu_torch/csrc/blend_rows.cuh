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

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace vk3d {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;  // one pixel a thread
constexpr int kStage = kThreads;         // rows a stage, one copied a thread
constexpr int64_t kSentinel = 0xFFFFFFFFLL;
constexpr float kSkipMargin = 1e-3f;

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

}  // namespace vk3d
