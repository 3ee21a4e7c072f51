"""The plain reference renderer the benchmark judges the port against.

Plain PyTorch, written from the reference renderer's shaders (Common.glsl,
InitSortList.comp, FindRanges.comp, RenderGaussians.comp) and nothing else:
it imports no module of the port and reads nothing the port made.  From the
gaussian table and the camera matrices it works out every stage again:

  projection and culling, the 2D covariance, the tile extents and the depth
  key, the SH colour, the inverse covariance  ->  one sort element per
  (gaussian, overlapped tile), gaussians in index order, cut at the capacity
  ->  the stable (tile, depth) order  ->  each tile's [start, end) range  ->
  the per-pixel front-to-back blend  ->  the 8-bit quantisation.

What it models.  Of the port's RenderConfig fields, it reads those in
`MODELLED` and no others; those in `IMAGE_NEUTRAL` select how the port
computes the frame, not which frame it computes.  The harness refuses,
before a run, a render setting in neither set that is away from its
default (run.render_settings).

Arithmetic.  The shaders' float32 expressions are written out with the
multiply-adds a GPU compiler contracts them to (`_fma`, one rounding, done
in float64 where the product is exact), so the integer results (depth keys,
tile extents, the cull) come out as a float32 GPU computes them, and the
float results within rounding.  Every float operation runs in `dt`:
float32 for the reference, bfloat16 for the control the benchmark's limits
are set against (`control.py`).

Every function takes plain tensors and a `Frame` of constants, and runs on
the tensors' device.  Memory: the projection holds a few [N, 3] rows at a
time, the element list three [E] int64 columns, the blend [tiles, 256]
state; a garden frame (5.8 M gaussians, 13 M elements) fits in a few GB.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

MAX_UINT32 = 0xFFFFFFFF
# RenderConfig fields the reference reads (through `frame_constants`).
MODELLED = frozenset({
    "width", "height", "tile_size", "near_plane", "far_plane", "shader_fov_y",
    "culling_ndc_limit", "in_view_limit", "covariance_dilation", "alpha_cutoff",
    "transmittance_stop", "sh_mode", "capacity_slack_per_tile", "capacity_pow_two",
})
# RenderConfig fields that leave the port's frame as it is, whatever their
# value: the projection matrix comes with the camera, so no frame path
# reads `proj_fov_y`; both sort tiers give the stable (tile, depth, index)
# order; the expansion and the blend's batch are schedules; the capped
# path's frames are exact, or flagged and counted in `failed`.
IMAGE_NEUTRAL = frozenset({
    "proj_fov_y", "sort_algorithm", "expansion_method", "blend_batch_k", "blend_depth_cap",
    "blend_cap_max", "packed_slack_per_tile", "cap_escalate_margin", "thr_publish_margin",
    "cap_decay_margin", "cap_validation_factor", "thr_reset_damp",
})
# getShColor's modes (Common.glsl:141-170).
ALL_BANDS, SKIP_FIRST_BAND, ONLY_FIRST_BAND = 0, 1, 2
SH_C = (
    0.2820947917738781, 0.4886025119029199, 0.9461746957575601, -0.31539156525252,
    1.865881662950577, -1.119528997770346, -0.48860251190292, -1.092548430592079,
    -2.285228997322329, 0.4570457994644658, 0.5462742152960395, 1.445305721320277,
    -0.5900435899266435,
)


class Cloud(NamedTuple):
    """A gaussian table as the renderer reads it (float32, one device).

    position [N, 3], scale [N, 3] (activated), rot [N, 4] (r, x, y, z,
    unit), sh [N, 16, 3] coefficient-major, opacity [N] (activated)."""

    position: torch.Tensor
    scale: torch.Tensor
    rot: torch.Tensor
    sh: torch.Tensor
    opacity: torch.Tensor


class Frame(NamedTuple):
    """The constants of one render (the configuration file's `render`)."""

    width: int
    height: int
    tile: int
    near: float
    far: float
    shader_fov_y: float
    ndc_limit: float
    in_view_limit: float
    dilation: float
    alpha_cutoff: float
    stop: float
    capacity: int
    sh_mode: int = ALL_BANDS

    @property
    def grid_w(self) -> int:
        return -(-self.width // self.tile)

    @property
    def grid_h(self) -> int:
        return -(-self.height // self.tile)

    @property
    def tiles(self) -> int:
        return self.grid_w * self.grid_h


def ceil_pow_two(x: int) -> int:
    """The least power of two >= x (Renderer::getCeilPowTwo)."""
    return 1 << max(x - 1, 0).bit_length()


def frame_constants(render: dict, num_gaussians: int) -> Frame:
    """The constants from a cell's render settings (the configuration's
    `render` group with the traffic's over it).  The capacity is the
    reference's N + slack * tiles, rounded up to a power of two where
    `capacity_pow_two` (ceilPow2, Renderer.cpp:725)."""
    w, h, t = render["width"], render["height"], render["tile_size"]
    tiles = -(-w // t) * -(-h // t)
    capacity = num_gaussians + render["capacity_slack_per_tile"] * tiles
    if render["capacity_pow_two"]:
        capacity = ceil_pow_two(capacity)
    return Frame(
        width=w, height=h, tile=t, near=render["near_plane"], far=render["far_plane"],
        shader_fov_y=render["shader_fov_y"], ndc_limit=render["culling_ndc_limit"],
        in_view_limit=render["in_view_limit"], dilation=render["covariance_dilation"],
        alpha_cutoff=render["alpha_cutoff"], stop=render["transmittance_stop"],
        capacity=capacity, sh_mode=int(render["sh_mode"]),
    )


# --- arithmetic in `dt` -----------------------------------------------------

def _r(x: float, dt) -> float:
    """A constant rounded to `dt`."""
    return float(torch.tensor(x, dtype=torch.float64).to(dt))


def _fma(a, b, c, dt):
    """a*b + c with one rounding to `dt`."""
    a, b, c = (x.double() if torch.is_tensor(x) else float(x) for x in (a, b, c))
    out = a * b + c
    return out.to(dt) if torch.is_tensor(out) else torch.tensor(out, dtype=dt)


def _sqrt(x: torch.Tensor, dt) -> torch.Tensor:
    """Correctly rounded square root."""
    return torch.sqrt(x.double()).to(dt)


def _dot3(x0, x1, x2, w0, w1, w2, dt):
    """x0*w0 + x1*w1 + x2*w2, contracted left to right."""
    return _fma(x2, w2, _fma(x1, w1, x0 * w0, dt), dt)


def _affine3(v, m, dt):
    """[N, 3] -> m[:3, :3] @ v + m[:3, 3], m a [4, 4] float list."""
    x0, x1, x2 = v[:, 0], v[:, 1], v[:, 2]
    return torch.stack([
        _dot3(x0, x1, x2, m[r][0], m[r][1], m[r][2], dt) + m[r][3] for r in range(3)
    ], dim=-1)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as GPU conversion does it (truncate, saturate, NaN 0),
    held in int64."""
    x = x.double()
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(x, -(2.0**31), 2.0**31 - 1).trunc().to(torch.int64)


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    return torch.remainder(v + 2**31, 2**32) - 2**31


class Projected(NamedTuple):
    """Per-gaussian results of the projection (InitSortList.comp)."""

    visible: torch.Tensor  # [N] bool: in front of the near plane, inside the NDC margin
    depth: torch.Tensor  # [N] int64 depth key in [0, 2^32)
    extents: torch.Tensor  # [N, 4] int64 (min_x, min_y, max_x, max_y) in tiles
    counts: torch.Tensor  # [N] int64 tiles overlapped, 0 if culled
    screen: torch.Tensor | None = None  # [N, 2] pixel position
    conic: torch.Tensor | None = None  # [N, 3] inverse covariance (a, b, c)
    color_alpha: torch.Tensor | None = None  # [N, 4] SH colour, alpha


def project(cloud: Cloud, view, proj, cam_pos, fr: Frame, dt=torch.float32, *,
            colour: bool = True) -> Projected:
    """Project every gaussian; `colour=False` stops after the counts."""
    view = [[_r(float(v), dt) for v in row] for row in view]
    proj = [[_r(float(v), dt) for v in row] for row in proj]
    pos = cloud.position.to(dt)

    # View transform, NDC and cull (InitSortList.comp:92-101).
    pv = _affine3(pos, view, dt)
    z = pv[:, 2]
    ndc = _affine3(pv, proj, dt) / (-z)[:, None]
    lim = _r(fr.ndc_limit, dt)
    visible = (-z > _r(fr.near, dt)) & (ndc[:, 0].abs() <= lim) & (ndc[:, 1].abs() <= lim)

    # Depth key (InitSortList.comp:70-80): the float product rounds to 2^32
    # at d == 1, which the conversion saturates to 0xFFFFFFFF.
    near = _r(fr.near, dt)
    inv_range = _r(_r(1.0, dt) / _r(_r(fr.far, dt) - near, dt), dt)
    d = torch.clamp((-z - near) * inv_range, 0.0, 1.0)
    f = d * _r(float(MAX_UINT32), dt)
    depth = torch.clamp(f.double(), max=4294967040.0).to(torch.int64)
    depth = torch.where(f.double() >= 4294967296.0, MAX_UINT32, depth)
    depth = torch.where(torch.isnan(f), 0, depth)

    # 2D covariance J W R S (R S)^T W^T J^T + dilation (Common.glsl:32-78).
    tan_y = math.tan(fr.shader_fov_y * 0.5)
    tan_x = tan_y * fr.width / fr.height
    focal_x, focal_y = _r(fr.width / (2.0 * tan_x), dt), _r(fr.height / (2.0 * tan_y), dt)
    q = cloud.rot.to(dt)
    qr, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]

    def one_minus(p, s, u, v):  # 1 - 2p*s - 2u*v
        return _fma(-(2.0 * u), v, _fma(-(2.0 * p), s, 1.0, dt), dt)

    def minus(p, s, u, v):  # 2p*s - 2u*v
        return _fma(2.0 * p, s, -((2.0 * u) * v), dt)

    def plus(p, s, u, v):  # 2p*s + 2u*v
        return _fma(2.0 * p, s, (2.0 * u) * v, dt)

    # Rotation matrix rows as GLSL's column-major literal (getRotMat).
    rot = torch.stack([
        torch.stack([one_minus(qy, qy, qz, qz), minus(qx, qy, qr, qz), plus(qx, qz, qr, qy)], -1),
        torch.stack([plus(qx, qy, qr, qz), one_minus(qx, qx, qz, qz), minus(qy, qz, qr, qx)], -1),
        torch.stack([minus(qx, qz, qr, qy), plus(qy, qz, qr, qx), one_minus(qx, qx, qy, qy)], -1),
    ], dim=-1)
    rs = rot * cloud.scale.to(dt)[:, None, :]
    del rot
    a = [_dot3(rs[:, 0, :], rs[:, 1, :], rs[:, 2, :], *view[r][:3], dt) for r in range(3)]
    del rs
    lim_x = _r(_r(tan_x, dt) * _r(fr.in_view_limit, dt), dt)
    lim_y = _r(_r(tan_y, dt) * _r(fr.in_view_limit, dt), dt)
    tx = torch.clamp(pv[:, 0] / z, -lim_x, lim_x) * z
    ty = torch.clamp(pv[:, 1] / z, -lim_y, lim_y) * z
    inv_z = 1.0 / z
    j00 = focal_x * inv_z
    j02 = -(focal_x * tx) * inv_z * inv_z
    j11 = focal_y * inv_z
    j12 = -(focal_y * ty) * inv_z * inv_z
    b0 = _fma(j00[:, None], a[0], j02[:, None] * a[2], dt)
    b1 = _fma(j11[:, None], a[1], j12[:, None] * a[2], dt)
    del a
    dil = _r(fr.dilation, dt)
    cx = _dot3(b0[:, 0], b0[:, 1], b0[:, 2], b0[:, 0], b0[:, 1], b0[:, 2], dt) + dil
    cy = _dot3(b0[:, 0], b0[:, 1], b0[:, 2], b1[:, 0], b1[:, 1], b1[:, 2], dt)
    cz = _dot3(b1[:, 0], b1[:, 1], b1[:, 2], b1[:, 0], b1[:, 1], b1[:, 2], dt) + dil
    del b0, b1

    # Screen position (Common.glsl:80-89) and tile extents, radius
    # ceil(3 sqrt(largest eigenvalue)) (InitSortList.comp:47-68).
    sx = (ndc[:, 0] + 1.0) * 0.5 * float(fr.width)
    sy = (-ndc[:, 1] + 1.0) * 0.5 * float(fr.height)
    del ndc
    det = _fma(cx, cz, -(cy * cy), dt)
    m = (cx + cz) * 0.5
    s = _sqrt(torch.clamp(_fma(m, m, -det, dt), min=0.0), dt)
    radius = torch.ceil(3.0 * _sqrt(torch.maximum(m + s, m - s), dt))
    ts = float(fr.tile)
    extents = torch.stack([
        torch.clamp(_to_i32((sx - radius) / ts), 0, fr.grid_w),
        torch.clamp(_to_i32((sy - radius) / ts), 0, fr.grid_h),
        torch.clamp(_wrap_i32(_to_i32((sx + radius) / ts) + 1), 0, fr.grid_w),
        torch.clamp(_wrap_i32(_to_i32((sy + radius) / ts) + 1), 0, fr.grid_h),
    ], dim=-1)
    w = extents[:, 2] - extents[:, 0]
    h = extents[:, 3] - extents[:, 1]
    counts = torch.where(visible, w * h, 0)
    if not colour:
        return Projected(visible, depth, extents, counts)

    # Inverse covariance (RenderGaussians.comp:94-105); a zero determinant
    # zeroes the alpha.
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / det, 0.0)
    conic = torch.stack([cz, -cy, cx], dim=-1) * det_inv[:, None]
    alpha = torch.where(det_ok, cloud.opacity.to(dt), 0.0)
    rgb = sh_colour(pos, cloud.sh.to(dt), cam_pos, dt, fr.sh_mode)
    return Projected(visible, depth, extents, counts, torch.stack([sx, sy], -1), conic,
                     torch.cat([rgb, alpha[:, None]], dim=-1))


def sh_colour(pos, sh, cam_pos, dt, mode: int = ALL_BANDS):
    """The SH colour seen from the camera in getShColor's `mode`, clamped at
    0 (getShEval4 and getShColor, Common.glsl:94-170): ALL_BANDS the 16
    coefficients + 0.5; SKIP_FIRST_BAND coefficients 1-15, - 0.5 + 0.5 as
    the shader writes it; ONLY_FIRST_BAND the DC term + 0.5."""
    if mode not in (ALL_BANDS, SKIP_FIRST_BAND, ONLY_FIRST_BAND):
        raise ValueError(f"unknown SH mode {mode}")
    cam = torch.tensor([_r(float(c), dt) for c in cam_pos], dtype=dt, device=pos.device)
    v = pos - cam
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    d = v / _sqrt(_dot3(v0, v1, v2, v0, v1, v2, dt), dt)[:, None]
    c = [_r(x, dt) for x in SH_C]
    fx, fy, fz = -d[:, 0], -d[:, 1], d[:, 2]
    fz2 = fz * fz
    p = [None] * 16
    p[0] = torch.full_like(fz, c[0])
    p[2] = c[1] * fz
    p[6] = _fma(c[2], fz2, c[3], dt)
    p[12] = fz * _fma(c[4], fz2, c[5], dt)
    p[3], p[1] = c[6] * fx, c[6] * fy
    tb = c[7] * fz
    p[7], p[5] = tb * fx, tb * fy
    tc = _fma(c[8], fz2, c[9], dt)
    p[13], p[11] = tc * fx, tc * fy
    fc1 = _fma(fx, fx, -(fy * fy), dt)
    fs1 = _fma(fx, fy, fy * fx, dt)
    p[8], p[4] = c[10] * fc1, c[10] * fs1
    tb = c[11] * fz
    p[14], p[10] = tb * fc1, tb * fs1
    fc2 = _fma(-fy, fs1, fx * fc1, dt)
    fs2 = _fma(fy, fc1, fx * fs1, dt)
    p[15], p[9] = c[12] * fc2, c[12] * fs2
    if mode == ONLY_FIRST_BAND:
        return torch.clamp(p[0][:, None] * sh[:, 0, :] + 0.5, min=0.0)
    first = 0 if mode == ALL_BANDS else 1
    acc = p[first][:, None] * sh[:, first, :]
    for k in range(first + 1, 16):
        acc = _fma(p[k][:, None], sh[:, k, :], acc, dt)
    if mode == SKIP_FIRST_BAND:
        acc = acc - 0.5
    return torch.clamp(acc + 0.5, min=0.0)


# --- elements, order, ranges ------------------------------------------------

class Sorted(NamedTuple):
    """The frame's sorted element list and each tile's range into it."""

    tile: torch.Tensor  # [L] int64 tile of each live element, sorted
    index: torch.Tensor  # [L] int64 gaussian of each live element
    ranges: torch.Tensor  # [tiles, 2] int64 [start, end)
    live: int  # live elements (the emitted count, cut at the capacity)


def sort_elements(p: Projected, fr: Frame) -> Sorted:
    """One element per (gaussian, overlapped tile): gaussians in index
    order, tiles row-major inside a gaussian's extent; elements past the
    capacity dropped (InitSortList.comp:133-150); then ordered by (tile,
    depth), stably, so ties keep gaussian order; then FindRanges.comp."""
    dev = p.counts.device
    counts = p.counts
    total = int(counts.sum())
    live = min(total, fr.capacity)
    g = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)[:live]
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(live, device=dev) - first[g]
    ext = p.extents[g]
    w = ext[:, 2] - ext[:, 0]
    tile = (ext[:, 1] + k // w) * fr.grid_w + ext[:, 0] + k % w
    del ext, k, w
    key = (tile << 32) | p.depth[g]
    order = torch.sort(key, stable=True).indices
    del key
    tile, index = tile[order], g[order]
    del order, g
    return Sorted(tile, index, find_ranges(tile, fr), live)


def find_ranges(tile: torch.Tensor, fr: Frame) -> torch.Tensor:
    """[tiles, 2] (start, end) of each tile in the sorted list; (0, 0) for
    an empty tile.  FindRanges.comp:44-70 writes only `end = E-1` at the
    list's last slot: a list filled to the capacity loses its last element,
    and a tile change at its last two slots leaves the end of the one and
    the start of the other at 0."""
    n = tile.shape[0]
    per = torch.bincount(tile, minlength=fr.tiles)
    end = torch.cumsum(per, 0)
    start = end - per
    empty = per == 0
    start = torch.where(empty, 0, start)
    end = torch.where(empty, 0, end)
    e = fr.capacity
    if n == e and e >= 2:
        last, prev = int(tile[e - 1]), int(tile[e - 2])
        end[last] = e - 1
        if prev != last:
            end[prev] = 0
            start[last] = 0
    return torch.stack([start, end], dim=1)


# --- blend and quantisation -------------------------------------------------

def blend_rows(p: Projected, dt=torch.float32) -> torch.Tensor:
    """[N, 9] per-gaussian blend rows: x, y, a' = -a/2, b' = -b, c' = -c/2,
    r, g, b, alpha (so that f = a'dx^2 + c'dy^2 + b'dxdy)."""
    c = p.conic
    return torch.cat([p.screen, c[:, 0:1] * -0.5, c[:, 1:2] * -1.0, c[:, 2:3] * -0.5,
                      p.color_alpha], dim=1).to(dt)


# Tiles' ranks stepped between two recomputations of the active tiles.
STEPS_A_SYNC = 32


def blend(rows: torch.Tensor, s: Sorted, fr: Frame) -> torch.Tensor:
    """Front to back over each tile's range, per pixel (RenderGaussians.comp
    :110-142): an element counts where f <= 0 and alpha = a_g exp(f) >=
    1/255; colour += T alpha rgb; T *= 1 - alpha; the pixel stops once T <
    stop.  Pixel (x, y) sits at integer coordinates.  Returns [H, W, 3] in
    [0, 1], in the rows' dtype."""
    dev, dt = rows.device, rows.dtype
    ts, gw = fr.tile, fr.grid_w
    npx = ts * ts
    tiles = torch.arange(fr.tiles, device=dev)
    pix = torch.arange(npx, device=dev)
    px = ((tiles % gw)[:, None] * ts + pix % ts).to(dt)
    py = ((tiles // gw)[:, None] * ts + pix // ts).to(dt)
    start = s.ranges[:, 0]
    length = s.ranges[:, 1] - start
    trans = torch.ones((fr.tiles, npx), dtype=dt, device=dev)
    colour = torch.zeros((fr.tiles, npx, 3), dtype=dt, device=dev)
    done = torch.zeros((fr.tiles, npx), dtype=torch.bool, device=dev)
    cutoff, stop = _r(fr.alpha_cutoff, dt), _r(fr.stop, dt)
    n = s.index.shape[0]
    act = torch.nonzero(length > 0).squeeze(1)
    r = 0
    while act.numel():
        st, ln = start[act], length[act]
        pxa, pya = px[act], py[act]
        t, c, dn = trans[act], colour[act], done[act]
        for _ in range(STEPS_A_SYNC):
            live = r < ln
            row = rows[s.index[torch.clamp(st + r, max=max(n - 1, 0))]]
            dx = row[:, 0:1] - pxa
            dy = pya - row[:, 1:2]
            f = (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy) + row[:, 3:4] * dx * dy
            alpha = row[:, 8:9] * torch.exp(f)
            elig = (f <= 0.0) & (alpha >= cutoff) & ~dn & live[:, None]
            w = torch.where(elig, t * alpha, 0.0)
            c = c + w[:, :, None] * row[:, None, 5:8]
            t = torch.where(elig, t * (1.0 - alpha), t)
            dn = dn | (t < stop)
            r += 1
        trans[act], colour[act], done[act] = t, c, dn
        keep = (r < ln) & ~dn.all(dim=1)
        act = act[keep]
    img = colour.reshape(fr.grid_h, gw, ts, ts, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(fr.grid_h * ts, gw * ts, 3)[: fr.height, : fr.width]
    return torch.clamp(img, 0.0, 1.0)


def quantize(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] in [0, 1] -> uint8, rounding half to even (rgba8 unorm)."""
    return torch.round(img * 255.0).to(torch.uint8)


def render(cloud: Cloud, view, proj, cam_pos, fr: Frame, dt=torch.float32):
    """The whole frame: ([H, W, 3] uint8 image, Projected, Sorted, rows)."""
    p = project(cloud, view, proj, cam_pos, fr, dt)
    s = sort_elements(p, fr)
    rows = blend_rows(p, dt)
    return quantize(blend(rows, s, fr)), p, s, rows


def live_count(cloud: Cloud, view, proj, cam_pos, fr: Frame) -> int:
    """Live elements of a frame (the emitted count, cut at the capacity)."""
    p = project(cloud, view, proj, cam_pos, fr, colour=False)
    return min(int(p.counts.sum()), fr.capacity)
