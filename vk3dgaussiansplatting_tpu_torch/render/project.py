"""Per-gaussian projection math, vectorized over the whole table.

Port of `vk3dgaussiansplatting_tpu.render.project` (the reference's GLSL in
Common.glsl + InitSortList.comp).  All math is float32 elementwise tensor
code.  It is the plain version of keygen's per-gaussian kernel: keygen
calls it (through `ops/cuda/keygen_kernel.project_gaussians_plain`) for
tables on the CPU, and on the card runs K7 (csrc/keygen.cu), which
computes these expressions with the same rounding, in one launch.  Nothing
on the card falls back to this code.

Integer results (depth keys, tile extents) must equal the JAX package's
bit for bit, so the float expressions follow what XLA computes, not merely
the same formula:

  * The 3-term dot products (view transform, projection, the A = W·R·S
    contraction) are what XLA lowers its small `dot`s to: a chain of fused
    multiply-adds, x0*w0 first.  A fused multiply-add of float32 operands is
    emulated in float64 (`_fma`): the product is exact there and the sum
    rounds once more, so it differs from a true fma only when the float64
    sum lands exactly on a float32 rounding tie (about 2^-29 of cases).
    Plain torch ops never contract, on the CPU or in CUDA, so nothing else
    fuses by accident.  A torch `matmul` or `einsum` is not used: its
    association is the BLAS library's.
  * Inside one XLA fusion, `p*q + r*s` contracts its first product,
    `1 - p*q - r*s` both (LLVM's rule); the same fused multiply-adds are
    written out where XLA forms them (`quat_rot_matrix`, `compute_cov2d`,
    `tile_extents`).
  * Division by a constant is XLA's multiply by the float32 reciprocal
    (`depth_key`).
  * sqrt is correctly rounded (`_sqrt`).
  * float32 -> int32 conversion saturates, NaN gives 0, and the `+ 1` after
    it wraps, as in XLA (`_xla_f32_to_i32`).  x86 torch would give INT_MIN
    for +inf and CUDA would saturate, so the cast is done in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import MAX_UINT32, RenderConfig, SphericalHarmonicsMode

F32 = np.float32


def _fma(a, b, c) -> torch.Tensor:
    """float32 a*b + c with one rounding (XLA's contracted multiply-add)."""
    a = a.double() if torch.is_tensor(a) else float(a)
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    return (a * b + c).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt: the float64 root of a float32 value
    rounds to the float32 root exactly.  (torch's vectorized CPU sqrt is off
    by one ulp on some inputs; CUDA's and XLA's are correctly rounded.)"""
    return torch.sqrt(x.double()).float()


def _dot3(x0, x1, x2, w0, w1, w2) -> torch.Tensor:
    """x0*w0 + x1*w1 + x2*w2 as XLA's fused reduction computes it."""
    return _fma(x2, w2, _fma(x1, w1, x0 * w0))


def _affine3(v: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """[N,3] rows -> m[:3,:3] @ row + m[:3,3], per output row (XLA's
    `v @ m[:3,:3].T + m[:3,3]`)."""
    x0, x1, x2 = v[:, 0], v[:, 1], v[:, 2]
    return torch.stack(
        [
            _dot3(x0, x1, x2, m[r, 0], m[r, 1], m[r, 2]) + float(m[r, 3])
            for r in range(3)
        ],
        dim=-1,
    )


def view_transform(position: torch.Tensor, view: np.ndarray) -> torch.Tensor:
    """World -> view space: rows of `view` [4,4] applied to [N,3] positions."""
    return _affine3(position, view)


def quat_rot_matrix(rot: torch.Tensor) -> torch.Tensor:
    """getRotMat (Common.glsl:17-30) for [N,4] quaternions (r,x,y,z).

    Returns [N,3,3] math matrices M[n, row, col] equal to the GLSL
    column-major literal (the transpose of the textbook rotation).  Each
    entry contracts as XLA does: 1 - 2pq - 2su folds both products into the
    constant, 2pq -+ 2su folds the first product."""
    r, x, y, z = rot[:, 0], rot[:, 1], rot[:, 2], rot[:, 3]

    def one_minus(p, q, s, u):  # 1 - 2p*q - 2s*u
        return _fma(-(2.0 * s), u, _fma(-(2.0 * p), q, 1.0))

    def minus(p, q, s, u):  # 2p*q - 2s*u
        return _fma(2.0 * p, q, -((2.0 * s) * u))

    def plus(p, q, s, u):  # 2p*q + 2s*u
        return _fma(2.0 * p, q, (2.0 * s) * u)

    col0 = torch.stack([one_minus(y, y, z, z), minus(x, y, r, z), plus(x, z, r, y)], dim=-1)
    col1 = torch.stack([plus(x, y, r, z), one_minus(x, x, z, z), minus(y, z, r, x)], dim=-1)
    col2 = torch.stack([minus(x, z, r, y), plus(y, z, r, x), one_minus(x, x, y, y)], dim=-1)
    return torch.stack([col0, col1, col2], dim=-1)


def focal_lengths(config: RenderConfig):
    """Focal lengths from the hard-coded shader FOV (Common.glsl:53-56),
    computed in float64 and rounded once to float32."""
    tan_fov_y = math.tan(config.shader_fov_y * 0.5)
    tan_fov_x = tan_fov_y * config.width / config.height
    focal_x = config.width / (2.0 * tan_fov_x)
    focal_y = config.height / (2.0 * tan_fov_y)
    return F32(tan_fov_x), F32(tan_fov_y), F32(focal_x), F32(focal_y)


def compute_cov2d(scale, rot, pos_view, view: np.ndarray, config: RenderConfig):
    """2D screen-space covariance (Σ'00, Σ'01, Σ'11) per gaussian, [N,3].

    getCovarianceMatrix (Common.glsl:32-78): Σ' = J W Σ Wᵀ Jᵀ with
    Σ = (R S)(R S)ᵀ, view-space xy clamped to the IN_VIEW_LIMIT margin before
    J, and +0.3 dilation on the diagonal.  Built as A = W·R·S and the two
    non-zero Jacobian rows contracted against it (the JAX association)."""
    tan_fov_x, tan_fov_y, focal_x, focal_y = focal_lengths(config)

    rs = quat_rot_matrix(rot) * scale[:, None, :]  # columns of R scaled
    w3 = view[:3, :3]
    # a[n, r, d] = sum_c w3[r, c] * rs[n, c, d]
    a = [
        _dot3(rs[:, 0, :], rs[:, 1, :], rs[:, 2, :], w3[r, 0], w3[r, 1], w3[r, 2])
        for r in range(3)
    ]

    x, y, z = pos_view[:, 0], pos_view[:, 1], pos_view[:, 2]
    lim_x = float(F32(tan_fov_x * F32(config.in_view_limit)))
    lim_y = float(F32(tan_fov_y * F32(config.in_view_limit)))
    tx = torch.clamp(x / z, -lim_x, lim_x) * z
    ty = torch.clamp(y / z, -lim_y, lim_y) * z

    inv_z = 1.0 / z
    fx, fy = float(focal_x), float(focal_y)
    j00 = fx * inv_z
    j02 = -(fx * tx) * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -(fy * ty) * inv_z * inv_z

    b0 = _fma(j00[:, None], a[0], j02[:, None] * a[2])
    b1 = _fma(j11[:, None], a[1], j12[:, None] * a[2])

    dil = float(F32(config.covariance_dilation))
    cov_x = _dot3(b0[:, 0], b0[:, 1], b0[:, 2], b0[:, 0], b0[:, 1], b0[:, 2]) + dil
    cov_y = _dot3(b0[:, 0], b0[:, 1], b0[:, 2], b1[:, 0], b1[:, 1], b1[:, 2])
    cov_z = _dot3(b1[:, 0], b1[:, 1], b1[:, 2], b1[:, 0], b1[:, 1], b1[:, 2]) + dil
    return torch.stack([cov_x, cov_y, cov_z], dim=-1)


def ndc_position(pos_view: torch.Tensor, proj: np.ndarray) -> torch.Tensor:
    """Full NDC xyz (used by culling, InitSortList.comp:97-101)."""
    clip = _affine3(pos_view, proj)
    w = -pos_view[:, 2]
    return clip / w[:, None]


def screen_space_position(pos_view, proj: np.ndarray, config: RenderConfig):
    """getScreenSpacePosition (Common.glsl:80-89): NDC -> pixel coords with
    y-flip.  Returns [N,2] float32 pixel positions."""
    ndc = ndc_position(pos_view, proj)
    sx = (ndc[:, 0] + 1.0) * 0.5 * float(config.width)
    sy = (-ndc[:, 1] + 1.0) * 0.5 * float(config.height)
    return torch.stack([sx, sy], dim=-1)


def depth_key(z_view: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """getDepthKey (InitSortList.comp:70-80) as int64 in [0, 2^32 - 1].

    GLSL computes `uint(clamp(d,0,1) * float(0xFFFFFFFF))`; the float32
    product rounds to 2^32 at d == 1, which GPU conversion saturates back to
    0xFFFFFFFF.  That saturation is explicit here, as in the JAX package."""
    near = F32(config.near_plane)
    inv_range = float(F32(1.0) / (F32(config.far_plane) - near))
    d = torch.clamp((-z_view - float(near)) * inv_range, 0.0, 1.0)
    f = d * float(F32(MAX_UINT32))
    key = torch.clamp(f, max=4294967040.0).to(torch.int64)
    key = torch.where(f >= 4294967296.0, MAX_UINT32, key)
    return torch.where(torch.isnan(f), 0, key)


def _xla_f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32 convert (truncate, saturate, NaN -> 0), as an
    int64 tensor holding the int32 value."""
    x = x.double()
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(x, -(2.0**31), 2.0**31 - 1).trunc().to(torch.int64)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int32 two's-complement wrap of an int64 tensor."""
    return torch.remainder(v + 2**31, 2**32) - 2**31


def tile_extents(screen_pos, cov2d, config: RenderConfig) -> torch.Tensor:
    """getGaussianTileExtents (InitSortList.comp:47-68): [N,4] int64
    (min_x, min_y, max_x, max_y), min inclusive / max exclusive, clamped to
    the tile grid; radius = ceil(3 * sqrt(max eigenvalue))."""
    cx, cy, cz = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = _fma(cx, cz, -(cy * cy))
    m = (cx + cz) * 0.5
    s = _sqrt(torch.clamp(_fma(m, m, -det), min=0.0))
    radius = torch.ceil(3.0 * _sqrt(torch.maximum(m + s, m - s)))

    ts = float(config.tile_size)
    gw, gh = config.grid_width, config.grid_height
    sx, sy = screen_pos[:, 0], screen_pos[:, 1]
    min_x = torch.clamp(_xla_f32_to_i32((sx - radius) / ts), 0, gw)
    min_y = torch.clamp(_xla_f32_to_i32((sy - radius) / ts), 0, gh)
    max_x = torch.clamp(_wrap_i32(_xla_f32_to_i32((sx + radius) / ts) + 1), 0, gw)
    max_y = torch.clamp(_wrap_i32(_xla_f32_to_i32((sy + radius) / ts) + 1), 0, gh)
    return torch.stack([min_x, min_y, max_x, max_y], dim=-1)


_SH_C = [F32(c) for c in (
    0.2820947917738781, 0.4886025119029199, 0.9461746957575601, -0.31539156525252,
    1.865881662950577, -1.119528997770346, -0.48860251190292, -1.092548430592079,
    -2.285228997322329, 0.4570457994644658, 0.5462742152960395, 1.445305721320277,
    -0.5900435899266435,
)]


def sh_basis16(eval_dir: torch.Tensor) -> torch.Tensor:
    """Degree-3 Sloan SH basis for [N,3] directions -> [N,16]
    (getShEval4, Common.glsl:94-138, including the (-x, -y, z) flip), with
    XLA's multiply-add contractions."""
    c = [float(v) for v in _SH_C]
    fx = -eval_dir[:, 0]
    fy = -eval_dir[:, 1]
    fz = eval_dir[:, 2]
    fz2 = fz * fz

    p = [None] * 16
    p[0] = torch.full_like(fz, c[0])
    p[2] = c[1] * fz
    p[6] = _fma(c[2], fz2, c[3])
    p[12] = fz * _fma(c[4], fz2, c[5])
    fc0, fs0 = fx, fy

    tmp_a = c[6]
    p[3] = tmp_a * fc0
    p[1] = tmp_a * fs0
    tmp_b = c[7] * fz
    p[7] = tmp_b * fc0
    p[5] = tmp_b * fs0
    tmp_c = _fma(c[8], fz2, c[9])
    p[13] = tmp_c * fc0
    p[11] = tmp_c * fs0
    fc1 = _fma(fx, fc0, -(fy * fs0))  # fx*fc0 - fy*fs0
    fs1 = _fma(fx, fs0, fy * fc0)  # fx*fs0 + fy*fc0

    tmp_a = c[10]
    p[8] = tmp_a * fc1
    p[4] = tmp_a * fs1
    tmp_b = c[11] * fz
    p[14] = tmp_b * fc1
    p[10] = tmp_b * fs1
    fc0b = _fma(-fy, fs1, fx * fc1)  # fx*fc1 - fy*fs1
    fs0b = _fma(fy, fc1, fx * fs1)  # fx*fs1 + fy*fc1

    tmp_c = c[12]
    p[15] = tmp_c * fc0b
    p[9] = tmp_c * fs0b
    return torch.stack(p, dim=-1)


def _sh_dot(basis: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """sum_c basis[:, c] * sh[:, c, :] as XLA's fused chain, c ascending."""
    acc = basis[:, 0:1] * sh[:, 0, :]
    for k in range(1, basis.shape[1]):
        acc = _fma(basis[:, k : k + 1], sh[:, k, :], acc)
    return acc


def sh_color(eval_dir, sh_coeffs, mode: SphericalHarmonicsMode) -> torch.Tensor:
    """getShColor (Common.glsl:141-170): SH -> rgb with the +0.5 offset and
    the non-negativity clamp."""
    basis = sh_basis16(eval_dir)  # [N,16]
    if mode == SphericalHarmonicsMode.ALL_BANDS:
        result = _sh_dot(basis, sh_coeffs)
    elif mode == SphericalHarmonicsMode.SKIP_FIRST_BAND:
        result = _sh_dot(basis[:, 1:], sh_coeffs[:, 1:, :]) - 0.5
    elif mode == SphericalHarmonicsMode.ONLY_FIRST_BAND:
        result = basis[:, 0:1] * sh_coeffs[:, 0, :]
    else:
        raise ValueError(f"unknown SH mode {mode}")
    return torch.clamp(result + 0.5, min=0.0)


def normalize_dirs(v: torch.Tensor) -> torch.Tensor:
    """GLSL normalize() for [N,3] (length 0 -> NaN, as in GLSL; callers cull
    such gaussians)."""
    x0, x1, x2 = v[:, 0], v[:, 1], v[:, 2]
    return v / _sqrt(_dot3(x0, x1, x2, x0, x1, x2))[:, None]
