// keygen's per-gaussian pass (K7) and slot decode (K8) — InitSortList.
//
// Not TPU kernels: these replace the part of the JAX package's
// vk3dgaussiansplatting_tpu/ops/keygen.py:126 generate_sort_elements that
// XLA compiles into fused device loops inside jax.jit (with
// render/project.py and ops/prefilter.py:gaussian_keep_mask), and its
// per-slot decode after the expansion (keygen.py:203-262).  Their plain
// versions are ops/cuda/keygen_kernel.py: project_gaussians_plain, the
// float32 torch code that writes XLA's arithmetic out op by op, and
// decode_slots_plain.
//
// K7 keygen_project, one thread per gaussian: the view transform, NDC and
// the near/NDC cull; the 32-bit depth key; the rotation matrix and the EWA
// 2D covariance; the screen position; the tile extents from the 3-sigma
// radius; with a dilated threshold map, the prefilter's keep mask; the
// emit count w * h (0 if culled or filtered).  Without `cols` (the counts
// mode of count_live_elements) it stops there.  Otherwise it also writes
// the SH16 colour, the inverse covariance with the det-zeroed alpha, the
// 2D covariance and screen position, and the int32 rows of the [6, N]
// packed columns that K1 expands (id, max(w, 1), min_x, min_y, the depth
// key's bits); row 1, the exclusive scan of the counts, is the wrapper's.
// Every gaussian gets its outputs, culled ones too.
//
// K8 decode_slots, one thread per slot: K1's [6, E] columns and the total
// -> the (tile, depth, index) int64 columns of SortElements, SENTINEL at and
// past min(total, E), and the clamped count.
//
// Arithmetic.  The integer outputs must equal the plain version's bit for
// bit, and through it the JAX package's, so every float op is the one XLA
// emits: __fmaf_rn exactly where project.py calls _fma (XLA's contracted
// multiply-adds), __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn everywhere else, which nvcc never contracts (the build's
// -fmad=true would otherwise fuse a*b+c at will and flip an extent).  No
// fast math.  Chains associate as project.py writes them (_dot3 is x0*w0
// first; the SH dot runs its coefficients ascending).  Constants (focal
// lengths, limits, 1/(far - near), the SH constants) arrive as float32
// values rounded on the host as the plain code rounds them.  XLA's float
// -> int32 convert truncates, saturates and maps NaN to 0; the `+ 1` after
// it wraps in int32 before the clamp.  torch.clamp and torch.maximum
// propagate NaN, fminf/fmaxf do not, so NaN is tested first.  The plain
// version's _fma rounds twice (float64, then float32): on a float32 tie,
// about 2^-29 of fmas, it is one ulp off, and __fmaf_rn is XLA's answer.
//
// What bounds K7 on the H100: bytes.  It reads 236 B a gaussian (position
// 12, scale 12, rot 16, opacity 4, the SH row 192) and writes 80 (frame
// data 48, five column rows 20, the count 8): 1.84 GB at garden's 5.83M
// gaussians, 0.55 ms at 3.35 TB/s; its ~400 flops a gaussian are 0.04 ms
// at 67 TFLOP/s.  The SH row is 12 float4 loads a thread (a thread's row
// is 192 contiguous bytes), consumed in order.  K8 reads 24 B and writes
// 24 B a slot (0.68 GB at E = 14.19M, 0.20 ms); its tile division is
// 32-bit wherever the slot's offset in its gaussian fits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShCoeffs = 16;
constexpr int kShFloats = kShCoeffs * 3;
constexpr int64_t kSentinel = 0xFFFFFFFFll;  // core/config.py SENTINEL

// Mirrors ops/cuda/keygen_kernel.py:KeygenParams field for field (every
// field is 4 bytes, so the layouts agree without padding).
struct KeygenParams {
  float view[12];  // rows 0-2 of the [4, 4] row-major view matrix
  float proj[8];   // rows 0-1 of the projection matrix
  float cam[3];
  float near_plane, ndc_limit, inv_range;
  float focal_x, focal_y, lim_x, lim_y, dilation;
  float width, height, tile_size;
  float sh_c[13];
  int32_t grid_w, grid_h, sh_mode, radius;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma1(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// project._dot3: x0*w0 + x1*w1 + x2*w2 as XLA's fused chain.
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float w0, float w1,
                                      float w2) {
  return fma1(x2, w2, fma1(x1, w1, mul(x0, w0)));
}

// IEEE's test (no fast math in this build, so it is not folded away).
__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// torch.clamp(x, lo, hi) and clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min_f(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}
// torch.maximum: NaN if either is.
__device__ __forceinline__ float maximum_f(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}

// XLA's float32 -> int32 convert: truncate, saturate, NaN -> 0.
__device__ __forceinline__ int32_t xla_f2i(float x) {
  if (is_nan(x)) return 0;
  if (x >= 2147483648.0f) return INT32_MAX;
  if (x <= -2147483648.0f) return INT32_MIN;
  return static_cast<int32_t>(x);
}
__device__ __forceinline__ int32_t wrap_inc(int32_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) + 1u);
}
__device__ __forceinline__ int32_t clamp_i(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// project.view_transform / ndc_position rows: m[r] . (x, y, z) + m[r][3].
// (The matrices stay in the launch's parameters: rows are indexed there, not
// through a pointer, which would copy them to a stack frame.)
__device__ __forceinline__ float affine_row(float m0, float m1, float m2, float m3, float x,
                                            float y, float z) {
  return add(dot3(x, y, z, m0, m1, m2), m3);
}
#define VK3D_ROW(m, r, x, y, z) affine_row(m[4 * (r)], m[4 * (r) + 1], m[4 * (r) + 2], \
                                           m[4 * (r) + 3], x, y, z)

// project.quat_rot_matrix's three entry forms.
__device__ __forceinline__ float one_minus(float p, float q, float s, float u) {
  return fma1(-mul(2.0f, s), u, fma1(-mul(2.0f, p), q, 1.0f));  // 1 - 2pq - 2su
}
__device__ __forceinline__ float minus2(float p, float q, float s, float u) {
  return fma1(mul(2.0f, p), q, -mul(mul(2.0f, s), u));  // 2pq - 2su
}
__device__ __forceinline__ float plus2(float p, float q, float s, float u) {
  return fma1(mul(2.0f, p), q, mul(mul(2.0f, s), u));  // 2pq + 2su
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads)
keygen_project_kernel(const float* __restrict__ position, const float* __restrict__ scale,
                      const float* __restrict__ rot, const float* __restrict__ opacity,
                      const float* __restrict__ sh, int64_t n, const KeygenParams p,
                      const int64_t* __restrict__ thr, int64_t* __restrict__ counts,
                      int32_t* __restrict__ cols, float* __restrict__ color_alpha,
                      float* __restrict__ cov2d_out, float* __restrict__ cov_inv_out,
                      float* __restrict__ screen_out, int32_t* __restrict__ extents_out,
                      uint8_t* __restrict__ flags_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float px = position[3 * i], py = position[3 * i + 1], pz = position[3 * i + 2];

  // View transform, NDC, cull (InitSortList.comp:92-101).
  const float vx = VK3D_ROW(p.view, 0, px, py, pz);
  const float vy = VK3D_ROW(p.view, 1, px, py, pz);
  const float vz = VK3D_ROW(p.view, 2, px, py, pz);
  const float w = -vz;
  const float ndc_x = dvd(VK3D_ROW(p.proj, 0, vx, vy, vz), w);
  const float ndc_y = dvd(VK3D_ROW(p.proj, 1, vx, vy, vz), w);
  const bool visible =
      w > p.near_plane && fabsf(ndc_x) <= p.ndc_limit && fabsf(ndc_y) <= p.ndc_limit;

  // Depth key (project.depth_key): saturates at 2^32, NaN -> 0.
  const float d = clamp_f(mul(sub(w, p.near_plane), p.inv_range), 0.0f, 1.0f);
  const float f = mul(d, 4294967296.0f);
  const uint32_t depth =
      is_nan(f) ? 0u : (f >= 4294967296.0f ? 0xFFFFFFFFu : static_cast<uint32_t>(f));

  // EWA 2D covariance (project.compute_cov2d): A = W R S, then the two
  // Jacobian rows.
  const float qr = rot[4 * i], qx = rot[4 * i + 1], qy = rot[4 * i + 2], qz = rot[4 * i + 3];
  const float s0 = scale[3 * i], s1 = scale[3 * i + 1], s2 = scale[3 * i + 2];
  float rs[3][3];
  rs[0][0] = mul(one_minus(qy, qy, qz, qz), s0);
  rs[1][0] = mul(minus2(qx, qy, qr, qz), s0);
  rs[2][0] = mul(plus2(qx, qz, qr, qy), s0);
  rs[0][1] = mul(plus2(qx, qy, qr, qz), s1);
  rs[1][1] = mul(one_minus(qx, qx, qz, qz), s1);
  rs[2][1] = mul(minus2(qy, qz, qr, qx), s1);
  rs[0][2] = mul(minus2(qx, qz, qr, qy), s2);
  rs[1][2] = mul(plus2(qy, qz, qr, qx), s2);
  rs[2][2] = mul(one_minus(qx, qx, qy, qy), s2);
  float a[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[r][c] = dot3(rs[0][c], rs[1][c], rs[2][c], p.view[4 * r], p.view[4 * r + 1],
                     p.view[4 * r + 2]);
    }
  }
  const float tx = mul(clamp_f(dvd(vx, vz), -p.lim_x, p.lim_x), vz);
  const float ty = mul(clamp_f(dvd(vy, vz), -p.lim_y, p.lim_y), vz);
  const float inv_z = dvd(1.0f, vz);
  const float j00 = mul(p.focal_x, inv_z);
  const float j02 = mul(mul(-mul(p.focal_x, tx), inv_z), inv_z);
  const float j11 = mul(p.focal_y, inv_z);
  const float j12 = mul(mul(-mul(p.focal_y, ty), inv_z), inv_z);
  float b0[3], b1[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    b0[c] = fma1(j00, a[0][c], mul(j02, a[2][c]));
    b1[c] = fma1(j11, a[1][c], mul(j12, a[2][c]));
  }
  const float cx = add(dot3(b0[0], b0[1], b0[2], b0[0], b0[1], b0[2]), p.dilation);
  const float cy = dot3(b0[0], b0[1], b0[2], b1[0], b1[1], b1[2]);
  const float cz = add(dot3(b1[0], b1[1], b1[2], b1[0], b1[1], b1[2]), p.dilation);

  // Screen position (project.screen_space_position).
  const float sx = mul(mul(add(ndc_x, 1.0f), 0.5f), p.width);
  const float sy = mul(mul(add(-ndc_y, 1.0f), 0.5f), p.height);

  // Tile extents (project.tile_extents).
  const float det = fma1(cx, cz, -mul(cy, cy));
  const float m = mul(add(cx, cz), 0.5f);
  const float s = __fsqrt_rn(clamp_min_f(fma1(m, m, -det), 0.0f));
  const float radius = ceilf(mul(3.0f, __fsqrt_rn(maximum_f(add(m, s), sub(m, s)))));
  const int32_t gw = p.grid_w, gh = p.grid_h;
  const int32_t min_x = clamp_i(xla_f2i(dvd(sub(sx, radius), p.tile_size)), 0, gw);
  const int32_t min_y = clamp_i(xla_f2i(dvd(sub(sy, radius), p.tile_size)), 0, gh);
  const int32_t max_x = clamp_i(wrap_inc(xla_f2i(dvd(add(sx, radius), p.tile_size))), 0, gw);
  const int32_t max_y = clamp_i(wrap_inc(xla_f2i(dvd(add(sy, radius), p.tile_size))), 0, gh);

  // The prefilter's keep mask (prefilter.gaussian_keep_mask).
  bool keep = true;
  if (thr != nullptr) {
    const int32_t tcx = clamp_i(xla_f2i(dvd(sx, p.tile_size)), 0, gw - 1);
    const int32_t tcy = clamp_i(xla_f2i(dvd(sy, p.tile_size)), 0, gh - 1);
    const int32_t r = p.radius;
    const bool coverable = min_x >= tcx - r && max_x <= tcx + r + 1 && min_y >= tcy - r &&
                           max_y <= tcy + r + 1;
    keep = !coverable || static_cast<int64_t>(depth) <= thr[tcy * gw + tcx];
  }
  const int32_t wt = max_x - min_x;
  const int32_t ht = max_y - min_y;
  counts[i] = visible && keep ? static_cast<int64_t>(wt) * ht : 0;
  if (extents_out != nullptr) {
    reinterpret_cast<int4*>(extents_out)[i] = make_int4(min_x, min_y, max_x, max_y);
  }
  if (flags_out != nullptr) {
    flags_out[i] = static_cast<uint8_t>((visible ? 1 : 0) | (keep ? 2 : 0));
  }
  if (!kFull) return;

  cols[i] = static_cast<int32_t>(i);
  cols[2 * n + i] = wt > 1 ? wt : 1;
  cols[3 * n + i] = min_x;
  cols[4 * n + i] = min_y;
  cols[5 * n + i] = static_cast<int32_t>(depth);

  // The covariance, its inverse and the screen position first, so that
  // little is live across the SH pass's divisions.  A zero determinant
  // zeroes the alpha.
  const bool det_ok = det != 0.0f;
  const float det_inv = det_ok ? dvd(1.0f, det) : 0.0f;
  cov2d_out[3 * i] = cx;
  cov2d_out[3 * i + 1] = cy;
  cov2d_out[3 * i + 2] = cz;
  cov_inv_out[3 * i] = mul(cz, det_inv);
  cov_inv_out[3 * i + 1] = mul(-cy, det_inv);
  cov_inv_out[3 * i + 2] = mul(cx, det_inv);
  reinterpret_cast<float2*>(screen_out)[i] = make_float2(sx, sy);

  // SH colour (project.normalize_dirs, sh_basis16, sh_color).
  const float ux = sub(px, p.cam[0]), uy = sub(py, p.cam[1]), uz = sub(pz, p.cam[2]);
  const float len = __fsqrt_rn(dot3(ux, uy, uz, ux, uy, uz));
  const float fx = -dvd(ux, len), fy = -dvd(uy, len), fz = dvd(uz, len);
  const float fz2 = mul(fz, fz);
  float b[kShCoeffs];
  b[0] = p.sh_c[0];
  b[2] = mul(p.sh_c[1], fz);
  b[6] = fma1(p.sh_c[2], fz2, p.sh_c[3]);
  b[12] = mul(fz, fma1(p.sh_c[4], fz2, p.sh_c[5]));
  b[3] = mul(p.sh_c[6], fx);
  b[1] = mul(p.sh_c[6], fy);
  const float tb = mul(p.sh_c[7], fz);
  b[7] = mul(tb, fx);
  b[5] = mul(tb, fy);
  const float tc = fma1(p.sh_c[8], fz2, p.sh_c[9]);
  b[13] = mul(tc, fx);
  b[11] = mul(tc, fy);
  const float fc1 = fma1(fx, fx, -mul(fy, fy));
  const float fs1 = fma1(fx, fy, mul(fy, fx));
  b[8] = mul(p.sh_c[10], fc1);
  b[4] = mul(p.sh_c[10], fs1);
  const float tb2 = mul(p.sh_c[11], fz);
  b[14] = mul(tb2, fc1);
  b[10] = mul(tb2, fs1);
  const float fc0b = fma1(-fy, fs1, mul(fx, fc1));
  const float fs0b = fma1(fy, fc1, mul(fx, fs1));
  b[15] = mul(p.sh_c[12], fc0b);
  b[9] = mul(p.sh_c[12], fs0b);

  // sum_k b[k] * sh[k][ch], k ascending: the row's 48 floats in order,
  // 4 at a time, element q being coefficient q / 3 of channel q % 3.
  const int mode = p.sh_mode;  // 0 all bands, 1 skip the first, 2 only the first
  const int first = mode == 1 ? 1 : 0;
  const int last = mode == 2 ? 0 : kShCoeffs - 1;
  const float4* row = reinterpret_cast<const float4*>(sh + kShFloats * i);
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int v = 0; v < kShFloats / 4; ++v) {
    if (4 * v > 3 * last + 2) break;
    const float4 q4 = __ldg(row + v);
    const float e[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int q = 4 * v + t;
      const int k = q / 3, ch = q % 3;
      if (k < first || k > last) continue;
      acc[ch] = k == first ? mul(b[k], e[t]) : fma1(b[k], e[t], acc[ch]);
    }
  }
  float rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float result = mode == 1 ? sub(acc[ch], 0.5f) : acc[ch];
    rgb[ch] = clamp_min_f(add(result, 0.5f), 0.0f);
  }

  reinterpret_cast<float4*>(color_alpha)[i] =
      make_float4(rgb[0], rgb[1], rgb[2], det_ok ? opacity[i] : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
decode_slots_kernel(const int32_t* __restrict__ cols, int64_t e,
                    const int64_t* __restrict__ total, int64_t grid_w,
                    int64_t* __restrict__ tile, int64_t* __restrict__ depth,
                    int64_t* __restrict__ index, int64_t* __restrict__ count) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t t = *total;
  const int64_t live = t < e ? t : e;
  if (j == 0) *count = live;
  if (j >= e) return;
  if (j >= live) {
    tile[j] = kSentinel;
    depth[j] = kSentinel;
    index[j] = kSentinel;
    return;
  }
  const int64_t local = j - cols[e + j];
  const int64_t gw = cols[2 * e + j] > 1 ? cols[2 * e + j] : 1;
  int64_t ly;
  if (local >= 0 && local <= 0xFFFFFFFFll) {
    ly = static_cast<uint32_t>(local) / static_cast<uint32_t>(gw);
  } else {  // floor division, as torch.div(rounding_mode="floor")
    ly = local / gw;
    if (local % gw != 0 && local < 0) --ly;
  }
  const int64_t lx = local - ly * gw;
  tile[j] = (cols[4 * e + j] + ly) * grid_w + (cols[3 * e + j] + lx);
  depth[j] = static_cast<int64_t>(static_cast<uint32_t>(cols[5 * e + j]));
  index[j] = cols[j];
}

}  // namespace

// params: a host pointer to the KeygenParams, copied into the launch.
// cols == NULL selects the counts mode (only `counts`, and the optional
// extents and flags, are written).  thr (the dilated [T] int64 threshold
// map), extents ([N, 4] int32) and flags ([N] uint8) may be NULL.  sh and
// color_alpha must be 16-byte aligned.
extern "C" int vk3d_keygen_project(const void* position, const void* scale, const void* rot,
                                   const void* opacity, const void* sh, int64_t n,
                                   const void* params, const void* thr, void* counts,
                                   void* cols, void* color_alpha, void* cov2d, void* cov_inv,
                                   void* screen_pos, void* extents, void* flags,
                                   int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const KeygenParams& p = *static_cast<const KeygenParams*>(params);
  if (p.sh_mode < 0 || p.sh_mode > 2 || p.grid_w <= 0 || p.grid_h <= 0 ||
      (cols != nullptr && (reinterpret_cast<uintptr_t>(sh) % 16 != 0 ||
                           reinterpret_cast<uintptr_t>(color_alpha) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  auto kernel = cols != nullptr ? keygen_project_kernel<true> : keygen_project_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(position), static_cast<const float*>(scale),
      static_cast<const float*>(rot), static_cast<const float*>(opacity),
      static_cast<const float*>(sh), n, p, static_cast<const int64_t*>(thr),
      static_cast<int64_t*>(counts), static_cast<int32_t*>(cols),
      static_cast<float*>(color_alpha), static_cast<float*>(cov2d),
      static_cast<float*>(cov_inv), static_cast<float*>(screen_pos),
      static_cast<int32_t*>(extents), static_cast<uint8_t*>(flags));
  return static_cast<int>(cudaGetLastError());
}

// cols: K1's [6, e] int32 columns; total: its [] int64 unclamped total.
// count ([] int64) is written even when e == 0.
extern "C" int vk3d_decode_slots(const void* cols, int64_t e, const void* total, int64_t grid_w,
                                 void* tile, void* depth, void* index, void* count,
                                 int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (e < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = e > 0 ? (e + kThreads - 1) / kThreads : 1;
  decode_slots_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), e, static_cast<const int64_t*>(total), grid_w,
      static_cast<int64_t*>(tile), static_cast<int64_t*>(depth), static_cast<int64_t*>(index),
      static_cast<int64_t*>(count));
  return static_cast<int>(cudaGetLastError());
}
