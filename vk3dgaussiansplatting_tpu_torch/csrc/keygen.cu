// keygen's per-gaussian pass with its offset scan (K7) — InitSortList.
//
// Not a TPU kernel: it replaces the part of the JAX package's
// vk3dgaussiansplatting_tpu/ops/keygen.py:126 generate_sort_elements that
// XLA compiles into fused device loops inside jax.jit (with
// render/project.py and ops/prefilter.py:gaussian_keep_mask, and the scan
// of the counts, keygen.py:192).  Its plain version is
// ops/cuda/keygen_kernel.py:project_gaussians_plain, the float32 torch
// code that writes XLA's arithmetic out op by op.  The per-slot decode
// after the expansion (keygen.py:203-262) is the expansion's own store
// phase (csrc/expand.cu, vk3d_expand_elements).
//
// K7 keygen_project, a block of kProjectThreads (64) consecutive
// gaussians, one thread each: the view transform, NDC and the near/NDC cull;
// the 32-bit depth key; the rotation matrix and the EWA 2D covariance; the screen position;
// the tile extents from the 3-sigma radius; with a dilated threshold map,
// the prefilter's keep mask; the emit count w * h (0 if culled or filtered),
// which stays in a register: what leaves the kernel is its scan.  The full
// mode (`cols` set) writes the SH16 colour, the inverse
// covariance with the det-zeroed alpha, the 2D covariance and screen
// position, the six int32 rows of the [6, N] packed columns that K1 expands
// (id, the exclusive offset clamped to the capacity, max(w, 1), min_x,
// min_y, the depth key's bits), the inclusive int64 scan `cum` [N] that
// K1's partition search reads and the [] int64 total.  Every gaussian gets
// its outputs, culled ones too, but for the colour: a gaussian whose count
// is 0 has no sort element, so no reader looks its colour up, and K7
// neither reads its SH row nor evaluates it: its rgb is 0 (its alpha is
// kept).  The counts mode (count_live_elements) is a
// kernel of its own, keygen_count_kernel: the same geometry, the total (and
// the optional extents and flags) only.
//
// The scan: decoupled look-back (Merrill & Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", NVR-2016-002).  A block takes its
// partition from an atomic ticket, never from blockIdx: the partitions
// before it have then all started, so its look-back never waits on a block
// that is not resident.  It computes its gaussians' counts, scans them
// inside the block, and publishes the block's sum as AGGREGATE (partition 0
// as INCLUSIVE); then it computes the frame data and the SH colour while
// its predecessors publish; last, warp 0 looks back, 32 predecessors a
// step, summing AGGREGATE words back to the nearest INCLUSIVE one,
// publishes its own INCLUSIVE prefix and the block writes the offsets and
// the scan.  A
// status word is 64 bits, the flag in the top two and the sum in the low
// 62 (a count sum passes 2^32 at 1080p: 8,160 tiles a gaussian), stored
// and loaded whole (st/ld.relaxed.gpu.u64): a reader never sees a flag
// without its sum, and nothing else is published through it, so no fence
// is needed.  The launcher zeroes the ticket and the status words before
// every launch (the caching allocator hands the scratch back holding the
// last call's flags).  Integer sums are exact, so the result does not
// depend on the blocks' timing.  The counts mode's kernel sums a thread's
// gaussians in a register and each block's sum into the zeroed total with
// one int64 atomicAdd (at most kCountBlocks of them).
//
// Staging.  A block's rows are contiguous ranges of the table: position
// and scale (12 B a row), rot (16 B) and the SH rows (192 B) are copied
// into shared memory with 16-byte cp.async, the geometry's group first.
// The block waits for it and computes each row's count; then each warp
// copies the SH rows of its rows whose count is above 0 (a ballot of the
// counts), and they land while the block scans, publishes its sum, writes
// its rows and stages its frame data.  A row is 192 B, six whole 32-byte
// sectors, so a row not copied is a row not read.  Chunk
// c of SH row r is stored at chunk 12 r + (c ^ ((r >> 1) & 3)), whose
// four banks start at quad 4 ((r & 1) ^ ((c >> 2) & 1)) + ((c & 3) ^
// ((r >> 1) & 3)) of the eight: a quarter warp (rows 8j .. 8j + 7) reading
// one logical chunk hits eight different quads, where the plain layout (a
// 48-float row stride) would serve it 4-way conflicted.
// Position and scale are read at a 3-float stride, conflict-free.  The
// 12-byte and 8-byte output rows (cov2d, cov_inv, screen_pos) are staged in
// shared memory too and stored as 16-byte runs of the block's contiguous
// range; cum, the column rows and the colour are one coalesced
// store a thread already.  Opacity is one coalesced 4-byte load a thread.
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
// What bounds K7 on the H100: bytes.  It reads 44 B a gaussian (position
// 12, scale 12, rot 16, opacity 4), plus the SH row's 192 B for each
// gaussian whose count is above 0, and writes 80 (frame data 48, six column
// rows 24, the scan 8): at garden's 5.83M gaussians, 3.73M of them
// emitting, 1.44 GB, 0.43 ms at 3.35 TB/s (1.84 GB if every row emitted);
// its ~370 flops a gaussian are 0.03 ms at 67 TFLOP/s.  The status words
// add 8 B a block.  The counts mode reads 40 B a gaussian (position,
// scale, rot) and writes the total.
//
// Shape, as measured on the H100 (PERF.md, K7's design): 64-thread
// blocks of 16.5 KB, 80 registers, twelve blocks an SM, ran faster than
// 128- and 256-thread blocks, whose block-wide phases leave fewer
// independent blocks to overlap.  Without the look-back (offsets wrong, a
// measuring copy only) the kernel ran at ~92% of the byte bound; the
// look-back, a few L2 round trips at each block's end, costs the rest.
// Looking back earlier (at once, or in a warp of its own while the others
// compute), reading more words a lane, a back-off in the wait, and
// persistent blocks that stage their next partition while looking back all
// ran slower: each makes a partition's AGGREGATE or INCLUSIVE word come
// later than its successors need it.  The SH gate (PERF.md, K7's row): each
// warp copying its emitting rows' SH right after its ballot ran 0.60 ms
// at garden's first pose, where 64% of the gaussians emit, and 0.69 with
// every gaussian in view, against 0.71 for both with every row copied at
// the start.  The block copying them after the scan's barrier (0.64 and
// 0.76 ms), the warps copying the rows that pass the near/NDC test before
// the rest of the geometry (0.61 and 0.70), or looking back while the rows
// land (0.70-0.72 and 0.78-0.84) ran slower.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // the counts mode's block
constexpr int kCountBlocks = 2048;  // the counts mode's most blocks (one atomicAdd each)
// K7's partition (gaussians, one thread each) and its register target.
constexpr int kProjectThreads = 64;
constexpr int kProjectMinBlocks = 12;  // blocks an SM
constexpr int kWarps = kProjectThreads / 32;
constexpr int kShCoeffs = 16;
constexpr int kShFloats = kShCoeffs * 3;
constexpr int kShChunks = kShFloats / 4;  // 16-byte chunks of an SH row

// Look-back status words: flag in bits 62-63, the sum below.
constexpr int kStatusSumBits = 62;
constexpr uint64_t kAggregate = uint64_t{1} << kStatusSumBits;
constexpr uint64_t kInclusive = uint64_t{2} << kStatusSumBits;
constexpr uint64_t kSumMask = kAggregate - 1;

// Shared memory of a block, in floats, each region 16-byte aligned: the
// staged position, scale and rot rows (the geometry's copy group), the SH
// rows (the second group), and the cov2d, cov_inv and screen_pos rows on
// their way out.
constexpr int kPosOff = 0;
constexpr int kScaleOff = kPosOff + 3 * kProjectThreads;
constexpr int kRotOff = kScaleOff + 3 * kProjectThreads;
constexpr int kShOff = kRotOff + 4 * kProjectThreads;
constexpr int kCovOff = kShOff + kShFloats * kProjectThreads;
constexpr int kInvOff = kCovOff + 3 * kProjectThreads;
constexpr int kScrOff = kInvOff + 3 * kProjectThreads;
constexpr size_t kFullSmem = (kScrOff + 2 * kProjectThreads) * sizeof(float);  // 16.5 KB

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

// The launch's tensors.  Inputs: the table's five columns (16-byte
// aligned) and the optional dilated threshold map.  Outputs of both modes:
// the total, extents and flags (the last two optional).  The full mode
// also writes the rest and uses `scratch`: the ticket, then one status
// word a partition.
struct Buffers {
  const float* position;
  const float* scale;
  const float* rot;
  const float* opacity;
  const float* sh;
  const int64_t* thr;
  int64_t* total;
  int32_t* extents;
  uint8_t* flags;
  int32_t* cols;
  int64_t* cum;
  float* color_alpha;
  float* cov2d;
  float* cov_inv;
  float* screen_pos;
  unsigned long long* scratch;
  int64_t n;
  int64_t capacity;
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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// `words` floats from g (16-byte aligned) into s: 16 bytes a copy, the
// last words (fewer than 4, the ragged last block only) one at a time.
__device__ __forceinline__ void stage(float* s, const float* g, int words) {
  const int chunks = words >> 2;
  for (int k = threadIdx.x; k < chunks; k += kProjectThreads) cp_async16(s + 4 * k, g + 4 * k);
  const int rest = 4 * chunks;
  if (static_cast<int>(threadIdx.x) < words - rest) {
    cp_async4(s + rest + threadIdx.x, g + rest + threadIdx.x);
  }
}

// The shared-memory chunk of chunk c of SH row r (the swizzle above).
__device__ __forceinline__ int sh_chunk(int r, int c) {
  return r * kShChunks + (c ^ ((r >> 1) & 3));
}

// The block's `words` staged floats out to g (16-byte aligned), 16 bytes a
// store where whole.
__device__ __forceinline__ void unstage(float* g, const float* s, int words) {
  const int chunks = words >> 2;
  for (int k = threadIdx.x; k < chunks; k += kProjectThreads) {
    reinterpret_cast<float4*>(g)[k] = reinterpret_cast<const float4*>(s)[k];
  }
  const int rest = 4 * chunks;
  if (static_cast<int>(threadIdx.x) < words - rest) g[rest + threadIdx.x] = s[rest + threadIdx.x];
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
  return v;
}

// What the geometry hands the rest of the pass.
struct Geometry {
  float cx, cy, cz, sx, sy, det;
  int32_t min_x, min_y, max_x, max_y;
  uint32_t depth;
  bool visible, keep;
};

// One gaussian's view transform, cull, depth key, EWA covariance, screen
// position, tile extents and keep mask (render/project.py, as XLA rounds).
__device__ __forceinline__ Geometry geometry(float px, float py, float pz, float s0, float s1,
                                             float s2, float4 q, const KeygenParams& p,
                                             const int64_t* __restrict__ thr) {
  Geometry g;
  // View transform, NDC, cull (InitSortList.comp:92-101).
  const float vx = VK3D_ROW(p.view, 0, px, py, pz);
  const float vy = VK3D_ROW(p.view, 1, px, py, pz);
  const float vz = VK3D_ROW(p.view, 2, px, py, pz);
  const float w = -vz;
  const float ndc_x = dvd(VK3D_ROW(p.proj, 0, vx, vy, vz), w);
  const float ndc_y = dvd(VK3D_ROW(p.proj, 1, vx, vy, vz), w);
  g.visible = w > p.near_plane && fabsf(ndc_x) <= p.ndc_limit && fabsf(ndc_y) <= p.ndc_limit;

  // Depth key (project.depth_key): saturates at 2^32, NaN -> 0.
  const float d = clamp_f(mul(sub(w, p.near_plane), p.inv_range), 0.0f, 1.0f);
  const float f = mul(d, 4294967296.0f);
  g.depth = is_nan(f) ? 0u : (f >= 4294967296.0f ? 0xFFFFFFFFu : static_cast<uint32_t>(f));

  // EWA 2D covariance (project.compute_cov2d): A = W R S, then the two
  // Jacobian rows.
  const float qr = q.x, qx = q.y, qy = q.z, qz = q.w;
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
  g.cx = add(dot3(b0[0], b0[1], b0[2], b0[0], b0[1], b0[2]), p.dilation);
  g.cy = dot3(b0[0], b0[1], b0[2], b1[0], b1[1], b1[2]);
  g.cz = add(dot3(b1[0], b1[1], b1[2], b1[0], b1[1], b1[2]), p.dilation);

  // Screen position (project.screen_space_position).
  g.sx = mul(mul(add(ndc_x, 1.0f), 0.5f), p.width);
  g.sy = mul(mul(add(-ndc_y, 1.0f), 0.5f), p.height);

  // Tile extents (project.tile_extents).
  g.det = fma1(g.cx, g.cz, -mul(g.cy, g.cy));
  const float m = mul(add(g.cx, g.cz), 0.5f);
  const float s = __fsqrt_rn(clamp_min_f(fma1(m, m, -g.det), 0.0f));
  const float radius = ceilf(mul(3.0f, __fsqrt_rn(maximum_f(add(m, s), sub(m, s)))));
  const int32_t gw = p.grid_w, gh = p.grid_h;
  g.min_x = clamp_i(xla_f2i(dvd(sub(g.sx, radius), p.tile_size)), 0, gw);
  g.min_y = clamp_i(xla_f2i(dvd(sub(g.sy, radius), p.tile_size)), 0, gh);
  g.max_x = clamp_i(wrap_inc(xla_f2i(dvd(add(g.sx, radius), p.tile_size))), 0, gw);
  g.max_y = clamp_i(wrap_inc(xla_f2i(dvd(add(g.sy, radius), p.tile_size))), 0, gh);

  // The prefilter's keep mask (prefilter.gaussian_keep_mask).
  g.keep = true;
  if (thr != nullptr) {
    const int32_t tcx = clamp_i(xla_f2i(dvd(g.sx, p.tile_size)), 0, gw - 1);
    const int32_t tcy = clamp_i(xla_f2i(dvd(g.sy, p.tile_size)), 0, gh - 1);
    const int32_t r = p.radius;
    const bool coverable = g.min_x >= tcx - r && g.max_x <= tcx + r + 1 && g.min_y >= tcy - r &&
                           g.max_y <= tcy + r + 1;
    g.keep = !coverable || static_cast<int64_t>(g.depth) <= thr[tcy * gw + tcx];
  }
  return g;
}

// SH colour (project.normalize_dirs, sh_basis16, sh_color) of the
// gaussian at (px, py, pz) from its staged SH row `r` of `s_sh`.
__device__ __forceinline__ float3 sh_colour(float px, float py, float pz, const float* s_sh,
                                            int r, const KeygenParams& p) {
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
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int v = 0; v < kShChunks; ++v) {
    if (4 * v > 3 * last + 2) break;
    const float4 q4 = reinterpret_cast<const float4*>(s_sh)[sh_chunk(r, v)];
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
  return make_float3(rgb[0], rgb[1], rgb[2]);
}

// The look-back, warp 0: lane l reads partition part - 1 - l of the
// window, each lane waiting until its word is published; the window's words
// up to the nearest INCLUSIVE one are summed, else all 32 and the window
// moves back.  Partition 0 is INCLUSIVE from the start, so the walk ends
// there at the latest (lanes before it read an INCLUSIVE 0).  Publishes the
// partition's INCLUSIVE prefix and returns its exclusive one.
__device__ __forceinline__ long long look_back(unsigned long long* status, int64_t part,
                                               long long aggregate, int lane) {
  long long excl = 0;
  if (part == 0) return excl;
  for (int64_t end = part - 1;; end -= 32) {
    const int64_t k = end - lane;
    unsigned long long word = kInclusive;
    if (k >= 0) {
      do {
        word = load_status(status + k);
      } while (word < kAggregate);
    }
    const unsigned inclusive = __ballot_sync(0xFFFFFFFFu, word >= kInclusive);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    excl += warp_sum(lane <= stop ? static_cast<long long>(word & kSumMask) : 0);
    if (inclusive) break;
  }
  if (lane == 0) {
    store_status(status + part, kInclusive | static_cast<unsigned long long>(excl + aggregate));
  }
  return excl;
}

__global__ void __launch_bounds__(kProjectThreads, kProjectMinBlocks)
keygen_project_kernel(const Buffers b, const KeygenParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long s_part;
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* s_pos = smem + kPosOff;
  const float* s_scale = smem + kScaleOff;

  // The partition: the ticket's (the look-back's order).
  if (tid == 0) s_part = atomicAdd(b.scratch, 1ull);
  __syncthreads();
  const auto part = static_cast<int64_t>(s_part);
  const int64_t base = part * kProjectThreads;
  const int rows = static_cast<int>(b.n - base < kProjectThreads ? b.n - base : kProjectThreads);

  // Stage the block's geometry rows and wait for them.
  stage(smem + kPosOff, b.position + 3 * base, 3 * rows);
  stage(smem + kScaleOff, b.scale + 3 * base, 3 * rows);
  stage(smem + kRotOff, b.rot + 4 * base, 4 * rows);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int64_t i = base + tid;
  const bool live = tid < rows;
  long long count = 0;
  Geometry g{};
  if (live) {
    g = geometry(s_pos[3 * tid], s_pos[3 * tid + 1], s_pos[3 * tid + 2], s_scale[3 * tid],
                 s_scale[3 * tid + 1], s_scale[3 * tid + 2],
                 reinterpret_cast<const float4*>(smem + kRotOff)[tid], p, b.thr);
    count = g.visible && g.keep
                ? static_cast<long long>(g.max_x - g.min_x) * (g.max_y - g.min_y)
                : 0;
  }

  // The SH rows of the warp's gaussians that emit, and of no other: its
  // lanes copy them (a ballot of the counts) and they land while the block
  // scans, publishes its sum, writes its rows and stages its frame data.
  const unsigned emits = __ballot_sync(0xFFFFFFFFu, count > 0);
  if (emits != 0) {
    const int row0 = 32 * warp;
    const float* sh = b.sh + kShFloats * (base + row0);
    const int chunks = (rows - row0 < 32 ? rows - row0 : 32) * kShChunks;
    for (int k = lane; k < chunks; k += 32) {
      const int r = k / kShChunks;
      if ((emits >> r) & 1) {
        cp_async16(smem + kShOff + 4 * sh_chunk(row0 + r, k - r * kShChunks), sh + 4 * k);
      }
    }
    cp_async_commit();
  }

  // The partition's scan of its counts: each warp's inclusive scan, then
  // the warps' sums.
  long long incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  long long before = 0, aggregate = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const long long v = s_warp[w];
    before += w < warp ? v : 0;
    aggregate += v;
  }
  unsigned long long* status = b.scratch + 1;
  if (tid == 0) {
    const unsigned long long flag = part == 0 ? kInclusive : kAggregate;
    store_status(status + part, flag | static_cast<unsigned long long>(aggregate));
  }

  if (live) {
    const int32_t wt = g.max_x - g.min_x;
    if (b.extents != nullptr) {
      reinterpret_cast<int4*>(b.extents)[i] = make_int4(g.min_x, g.min_y, g.max_x, g.max_y);
    }
    if (b.flags != nullptr) {
      b.flags[i] = static_cast<uint8_t>((g.visible ? 1 : 0) | (g.keep ? 2 : 0));
    }
    const int64_t n = b.n;
    b.cols[i] = static_cast<int32_t>(i);
    b.cols[2 * n + i] = wt > 1 ? wt : 1;
    b.cols[3 * n + i] = g.min_x;
    b.cols[4 * n + i] = g.min_y;
    b.cols[5 * n + i] = static_cast<int32_t>(g.depth);
  }

  // The frame data while the predecessors publish.  The covariance, its
  // inverse and the screen position go out through shared memory; a zero
  // determinant zeroes the alpha.
  float* s_cov = smem + kCovOff;
  float* s_inv = smem + kInvOff;
  float* s_scr = smem + kScrOff;
  const bool det_ok = g.det != 0.0f;
  if (live) {
    const float det_inv = det_ok ? dvd(1.0f, g.det) : 0.0f;
    s_cov[3 * tid] = g.cx;
    s_cov[3 * tid + 1] = g.cy;
    s_cov[3 * tid + 2] = g.cz;
    s_inv[3 * tid] = mul(g.cz, det_inv);
    s_inv[3 * tid + 1] = mul(-g.cy, det_inv);
    s_inv[3 * tid + 2] = mul(g.cx, det_inv);
    s_scr[2 * tid] = g.sx;
    s_scr[2 * tid + 1] = g.sy;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (live) {
    // No reader looks up the colour of a gaussian without an element.
    const float3 rgb = count > 0 ? sh_colour(s_pos[3 * tid], s_pos[3 * tid + 1],
                                             s_pos[3 * tid + 2], smem + kShOff, tid, p)
                                 : make_float3(0.0f, 0.0f, 0.0f);
    reinterpret_cast<float4*>(b.color_alpha)[i] =
        make_float4(rgb.x, rgb.y, rgb.z, det_ok ? __ldg(b.opacity + i) : 0.0f);
  }
  unstage(b.cov2d + 3 * base, s_cov, 3 * rows);
  unstage(b.cov_inv + 3 * base, s_inv, 3 * rows);
  unstage(b.screen_pos + 2 * base, s_scr, 2 * rows);

  // The look-back last: the predecessors have had the longest time to
  // publish.
  if (warp == 0) {
    const long long excl = look_back(status, part, aggregate, lane);
    if (lane == 0) s_prefix = excl;
  }
  __syncthreads();
  if (live) {
    const long long off = s_prefix + before + incl - count;
    b.cols[b.n + i] = static_cast<int32_t>(off < b.capacity ? off : b.capacity);
    b.cum[i] = off + count;
    if (i == b.n - 1) *b.total = off + count;
  }
}

// K7's counts mode: the geometry's counts (and extents and flags where
// asked), a thread's gaussians strided over the grid and summed in a
// register, then one atomicAdd a block into the zeroed total.  It reads 40
// B a gaussian, coalesced enough through L1 that staging buys nothing, and
// writes no row unless the extents or flags are asked for.
__global__ void __launch_bounds__(kThreads) keygen_count_kernel(const Buffers b,
                                                                const KeygenParams p) {
  __shared__ long long s_warp[kThreads / 32];
  long long sum = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < b.n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const Geometry g = geometry(__ldg(b.position + 3 * i), __ldg(b.position + 3 * i + 1),
                                __ldg(b.position + 3 * i + 2), __ldg(b.scale + 3 * i),
                                __ldg(b.scale + 3 * i + 1), __ldg(b.scale + 3 * i + 2),
                                __ldg(reinterpret_cast<const float4*>(b.rot) + i), p, b.thr);
    const long long count =
        g.visible && g.keep ? static_cast<long long>(g.max_x - g.min_x) * (g.max_y - g.min_y) : 0;
    if (b.extents != nullptr) {
      reinterpret_cast<int4*>(b.extents)[i] = make_int4(g.min_x, g.min_y, g.max_x, g.max_y);
    }
    if (b.flags != nullptr) {
      b.flags[i] = static_cast<uint8_t>((g.visible ? 1 : 0) | (g.keep ? 2 : 0));
    }
    sum += count;
  }
  sum = warp_sum(sum);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long block = 0;
    for (int w = 0; w < kThreads / 32; ++w) block += s_warp[w];
    if (block != 0) {
      atomicAdd(reinterpret_cast<unsigned long long*>(b.total),
                static_cast<unsigned long long>(block));
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// K7's shared memory: a carveout asking for the most shared memory, so that
// twelve 16.5 KB blocks fit an SM.  A host call made once a device per
// process (a bit of `asked` each, devices from 64 on every time); a refused
// call is returned and made again next launch.
static_assert(kFullSmem <= 48 * 1024, "K7's block fits the default dynamic shared memory");
cudaError_t prefer_shared(int device) {
  static std::atomic<uint64_t> asked{0};
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (bit != 0 && (asked.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(keygen_project_kernel,
                                               cudaFuncAttributePreferredSharedMemoryCarveout,
                                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) asked.fetch_or(bit, std::memory_order_release);
  return err;
}

// The full mode's scratch, in int64 words: the ticket and one status word
// a partition.  -1 where the launch would be refused: n outside [0, 2^31)
// (the ids are int32), tiles < 1, or n * tiles past the status words' 62-bit
// sums.
int64_t scratch_words(int64_t n, int64_t tiles) {
  if (n < 0 || n >= (int64_t{1} << 31) || tiles < 1) return -1;
  if (n > 0 && tiles > static_cast<int64_t>(kSumMask) / n) return -1;
  return 1 + (n + kProjectThreads - 1) / kProjectThreads;
}

}  // namespace

extern "C" int64_t vk3d_keygen_scratch_words(int64_t n, int64_t tiles) {
  return scratch_words(n, tiles);
}

// params: a host pointer to the KeygenParams, copied into the launch.
// cols == NULL selects the counts mode (the total, and the optional extents
// and flags, are written; cum, the frame data and scratch are not read).
// The full mode writes the [6, n] cols (row 1 the exclusive offset clamped
// to `capacity`), cum [n], total and the frame data, and needs `scratch`:
// scratch_words >= vk3d_keygen_scratch_words(n, tiles) int64 words, zeroed
// here before the launch.  thr (the dilated [T] int64 threshold map),
// extents ([N, 4] int32) and flags ([N] uint8) may be NULL.  The five table
// columns and the float outputs must be 16-byte aligned.  The total is
// written for n == 0 too.
extern "C" int vk3d_keygen_project(const void* position, const void* scale, const void* rot,
                                   const void* opacity, const void* sh, int64_t n,
                                   const void* params, const void* thr, void* total,
                                   void* extents, void* flags, void* cols, int64_t capacity,
                                   void* cum, void* color_alpha, void* cov2d, void* cov_inv,
                                   void* screen_pos, void* scratch, int64_t scratch_words_,
                                   int32_t device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const KeygenParams& p = *static_cast<const KeygenParams*>(params);
  const bool full = cols != nullptr;
  const int64_t words = scratch_words(n, static_cast<int64_t>(p.grid_w) * p.grid_h);
  if (words < 0 || p.sh_mode < 0 || p.sh_mode > 2 || p.grid_w <= 0 || p.grid_h <= 0 ||
      total == nullptr || (full && capacity < 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  // The counts mode adds into the total, which starts at zero, as does the
  // total of an empty table (whose other tensors hold no memory).
  if (!full || n == 0) {
    if ((err = cudaMemsetAsync(total, 0, sizeof(int64_t), s)) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (!aligned16(position) || !aligned16(scale) || !aligned16(rot) || !aligned16(sh) ||
      (full && (cum == nullptr || scratch == nullptr || scratch_words_ < words ||
                !aligned16(color_alpha) || !aligned16(cov2d) || !aligned16(cov_inv) ||
                !aligned16(screen_pos)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The full mode's ticket and status words start at zero.
  if (full && (err = cudaMemsetAsync(scratch, 0, words * sizeof(int64_t), s)) != cudaSuccess) {
    return static_cast<int>(err);
  }

  Buffers b{};
  b.position = static_cast<const float*>(position);
  b.scale = static_cast<const float*>(scale);
  b.rot = static_cast<const float*>(rot);
  b.opacity = static_cast<const float*>(opacity);
  b.sh = static_cast<const float*>(sh);
  b.thr = static_cast<const int64_t*>(thr);
  b.total = static_cast<int64_t*>(total);
  b.extents = static_cast<int32_t*>(extents);
  b.flags = static_cast<uint8_t*>(flags);
  b.cols = static_cast<int32_t*>(cols);
  b.cum = static_cast<int64_t*>(cum);
  b.color_alpha = static_cast<float*>(color_alpha);
  b.cov2d = static_cast<float*>(cov2d);
  b.cov_inv = static_cast<float*>(cov_inv);
  b.screen_pos = static_cast<float*>(screen_pos);
  b.scratch = static_cast<unsigned long long*>(scratch);
  b.n = n;
  b.capacity = capacity;

  if (!full) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    keygen_count_kernel<<<static_cast<unsigned int>(blocks < kCountBlocks ? blocks : kCountBlocks),
                          kThreads, 0, s>>>(b, p);
    return static_cast<int>(cudaGetLastError());
  }
  if ((err = prefer_shared(device)) != cudaSuccess) return static_cast<int>(err);
  keygen_project_kernel<<<static_cast<unsigned int>(words - 1), kProjectThreads, kFullSmem, s>>>(
      b, p);
  return static_cast<int>(cudaGetLastError());
}
