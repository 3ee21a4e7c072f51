"""keygen's per-gaussian pass with its offset scan (K7) — the wrapper of
csrc/keygen.cu.

It replaces no TPU kernel: it replaces the part of the JAX package's
`ops/keygen.py:126 generate_sort_elements` that XLA compiles into fused
device loops under `jax.jit` (the view transform and cull, the depth key,
the EWA covariance, the tile extents, the SH16 colour, the inverse
covariance, the prefilter's keep mask and the scan of the counts).  The
per-slot decode that turns the expansion into the sort elements is the
expansion's own store (`expand_kernel.expand_elements`).

`project_gaussians` launches K7 for CUDA tensors and runs
`project_gaussians_plain` for CPU tensors (`_build.on_card`).  It never
falls back from one to the other: a failed build, launch or shared-memory
opt-in raises, and the launcher raises `ValueError` for a tensor that is
not on a CUDA device.
The plain version is the torch code that writes XLA's float32 arithmetic
out op by op (`render/project.py`) and scans with `torch.cumsum`; K7
computes the same expressions with the same rounding (csrc/keygen.cu,
"Arithmetic") and the scan by decoupled look-back in the same launch, so a
card keygen pass is K7 and K1's partition search and expansion, with no
PyTorch kernel between them.  `_build.LAUNCHES` counts K7's full launches
as "keygen_project" and its counts-only launches (`count_live_elements`)
as "keygen_count".
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...core.config import RenderConfig, SphericalHarmonicsMode
from ...render import project
from .. import prefilter
from . import _build

NUM_COLS = 6  # id, offset, max(w, 1), min_x, min_y, depth bits
F32 = np.float32


class Projection(NamedTuple):
    """Per-gaussian results of keygen's projection pass.  The emit counts
    w*h (0 if culled or filtered out) are not kept: `cum` holds them.

    total:   [] int64 sum of the counts, unclamped
    cum:     [N] int64 inclusive scan of the counts (what K1 reads)
    cols:    [6, N] int32 packed rows K1 expands: id, exclusive offset
             (clamped to the capacity), max(w, 1), min_x, min_y, the depth
             key's int32 bits
    color_alpha [N,4], cov2d [N,3], cov_inv [N,3], screen_pos [N,2]:
             float32 frame data (ops/keygen.py:GaussianFrameData); the rgb
             is 0 where the count is 0 (K7 reads no SH row there)
    extents: [N, 4] int32 (min_x, min_y, max_x, max_y), with `with_aux`
    flags:   [N] uint8, bit 0 visible, bit 1 kept by the prefilter, with
             `with_aux`
    In the counts mode only `total` and the aux outputs are set.
    """

    total: torch.Tensor
    cum: torch.Tensor | None = None
    cols: torch.Tensor | None = None
    color_alpha: torch.Tensor | None = None
    cov2d: torch.Tensor | None = None
    cov_inv: torch.Tensor | None = None
    screen_pos: torch.Tensor | None = None
    extents: torch.Tensor | None = None
    flags: torch.Tensor | None = None


class KeygenParams(ctypes.Structure):
    """csrc/keygen.cu's KeygenParams: the camera rows and the config's
    constants, each rounded to float32 as the plain version rounds it."""

    _fields_ = [
        ("view", ctypes.c_float * 12),
        ("proj", ctypes.c_float * 8),
        ("cam", ctypes.c_float * 3),
        ("near_plane", ctypes.c_float),
        ("ndc_limit", ctypes.c_float),
        ("inv_range", ctypes.c_float),
        ("focal_x", ctypes.c_float),
        ("focal_y", ctypes.c_float),
        ("lim_x", ctypes.c_float),
        ("lim_y", ctypes.c_float),
        ("dilation", ctypes.c_float),
        ("width", ctypes.c_float),
        ("height", ctypes.c_float),
        ("tile_size", ctypes.c_float),
        ("sh_c", ctypes.c_float * 13),
        ("grid_w", ctypes.c_int32),
        ("grid_h", ctypes.c_int32),
        ("sh_mode", ctypes.c_int32),
        ("radius", ctypes.c_int32),
    ]


_TABLE_SHAPES = {"position": (3,), "scale": (3,), "rot": (4,), "sh": (16, 3), "opacity": ()}


def _check(table, thr_dilated, config: RenderConfig) -> None:
    n = table.position.shape[0] if table.position.dim() else -1
    for name, tail in _TABLE_SHAPES.items():
        t = getattr(table, name)
        if t.dtype != torch.float32 or tuple(t.shape) != (n, *tail):
            raise ValueError(f"table.{name} must be [N{''.join(f', {d}' for d in tail)}] "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if thr_dilated is not None:
        if thr_dilated.dtype != torch.int64 or tuple(thr_dilated.shape) != (config.num_tiles,):
            raise ValueError(f"thresholds must be [{config.num_tiles}] int64, got "
                             f"{tuple(thr_dilated.shape)} {thr_dilated.dtype}")
    if config.sh_mode not in tuple(SphericalHarmonicsMode):
        raise ValueError(f"unknown SH mode {config.sh_mode}")


def cull_mask(pos_view, ndc, config: RenderConfig) -> torch.Tensor:
    """Near-plane + NDC-margin culling (InitSortList.comp:92-101)."""
    near_ok = -pos_view[:, 2] > float(F32(config.near_plane))
    lim = float(F32(config.culling_ndc_limit))
    return near_ok & (ndc[:, 0].abs() <= lim) & (ndc[:, 1].abs() <= lim)


def project_gaussians_plain(table, view, proj, cam_pos, config: RenderConfig, capacity=None,
                            thr_dilated=None, *, with_aux=False) -> Projection:
    """K7's plain version: `render/project.py`'s float32 torch code, XLA's
    fused multiply-adds written out.  `capacity=None` is the counts mode."""
    view, proj, cam_pos = (np.asarray(a, np.float32) for a in (view, proj, cam_pos))
    pos_view = project.view_transform(table.position, view)
    ndc = project.ndc_position(pos_view, proj)
    visible = cull_mask(pos_view, ndc, config)
    depth = project.depth_key(pos_view[:, 2], config)
    cov2d = project.compute_cov2d(table.scale, table.rot, pos_view, view, config)
    screen_pos = project.screen_space_position(pos_view, proj, config)
    extents = project.tile_extents(screen_pos, cov2d, config)
    if thr_dilated is None:
        keep = torch.ones_like(visible)
    else:
        keep = prefilter.gaussian_keep_mask(screen_pos, extents, depth, thr_dilated, config)
    w = extents[:, 2] - extents[:, 0]
    h = extents[:, 3] - extents[:, 1]
    counts = torch.where(visible & keep, w * h, 0)
    aux = {}
    if with_aux:
        aux = {"extents": extents.to(torch.int32),
               "flags": (visible.to(torch.uint8) | (keep.to(torch.uint8) << 1))}
    if capacity is None:
        return Projection(counts.sum(), **aux)

    # SH colour (InitSortList.comp:122-126), of the gaussians that emit:
    # no reader looks up any other's, and K7 reads no other SH row.
    cam = torch.as_tensor(cam_pos, device=table.position.device)
    to_gauss = project.normalize_dirs(table.position - cam[None, :])
    rgb = project.sh_color(to_gauss, table.sh, config.sh_mode)
    rgb = torch.where((counts > 0)[:, None], rgb, 0.0)

    # Inverse 2D covariance (RenderGaussians.comp:94-105): a zero determinant
    # zeroes the alpha instead.
    det = project._fma(cov2d[:, 0], cov2d[:, 2], -(cov2d[:, 1] * cov2d[:, 1]))
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / det, 0.0)
    cov_inv = torch.stack([cov2d[:, 2], -cov2d[:, 1], cov2d[:, 0]], dim=-1) * det_inv[:, None]
    alpha = torch.where(det_ok, table.opacity, 0.0)
    n = table.position.shape[0]
    cum = torch.cumsum(counts, 0)
    cols = torch.stack([
        torch.arange(n, device=counts.device, dtype=torch.int64),
        (cum - counts).clamp(max=capacity),  # the exclusive offsets, clamped
        w.clamp(min=1),
        extents[:, 0],
        extents[:, 1],
        torch.where(depth >= 2**31, depth - 2**32, depth),  # the key's int32 bits
    ]).to(torch.int32)
    return Projection(counts.sum(), cum, cols, torch.cat([rgb, alpha[:, None]], dim=-1), cov2d,
                      cov_inv, screen_pos, **aux)


def keygen_params(view, proj, cam_pos, config: RenderConfig) -> KeygenParams:
    """K7's constants, rounded to float32 as the plain version rounds them
    (render/project.py: depth_key, focal_lengths, compute_cov2d, _SH_C)."""
    tan_fov_x, tan_fov_y, focal_x, focal_y = project.focal_lengths(config)
    near = F32(config.near_plane)
    p = KeygenParams()
    p.view[:] = np.asarray(view, np.float32)[:3].ravel().tolist()
    p.proj[:] = np.asarray(proj, np.float32)[:2].ravel().tolist()
    p.cam[:] = np.asarray(cam_pos, np.float32).tolist()
    p.near_plane = float(near)
    p.ndc_limit = float(F32(config.culling_ndc_limit))
    p.inv_range = float(F32(1.0) / (F32(config.far_plane) - near))
    p.focal_x, p.focal_y = float(focal_x), float(focal_y)
    p.lim_x = float(F32(tan_fov_x * F32(config.in_view_limit)))
    p.lim_y = float(F32(tan_fov_y * F32(config.in_view_limit)))
    p.dilation = float(F32(config.covariance_dilation))
    p.width, p.height, p.tile_size = config.width, config.height, config.tile_size
    p.sh_c[:] = [float(c) for c in project._SH_C]
    p.grid_w, p.grid_h = config.grid_width, config.grid_height
    p.sh_mode = int(config.sh_mode)
    p.radius = prefilter.RADIUS
    return p


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and 16-byte aligned (K7 stages its rows 16 B at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _outputs(n: int, dev: torch.device, scratch_words: int | None, with_aux: bool):
    """K7's output tensors, unset, as a Projection, and the full mode's
    scratch of `scratch_words` int64 words (the ticket and a status word a
    block, as vk3d_keygen_scratch_words counts them; the launcher zeroes
    it); `scratch_words=None` is the counts mode.  Three allocations: the
    int64 results (total, cum, scratch) are views of one, the float32 frame
    data of another (each field 16-byte aligned), the int32 columns a
    third."""
    full = scratch_words is not None
    ints = torch.empty(((1 + n + scratch_words) if full else 1,), dtype=torch.int64, device=dev)
    out = Projection(ints[0])
    scratch = None
    if full:
        def aligned(k):  # float offsets a multiple of 4 (16 bytes)
            return -(-k // 4) * 4

        inv = aligned(7 * n)
        scr = aligned(inv + 3 * n)
        floats = torch.empty((scr + 2 * n,), dtype=torch.float32, device=dev)
        out = out._replace(cum=ints[1: n + 1],
                           cols=torch.empty((NUM_COLS, n), dtype=torch.int32, device=dev),
                           color_alpha=floats[:4 * n].view(n, 4),
                           cov2d=floats[4 * n: 7 * n].view(n, 3),
                           cov_inv=floats[inv: inv + 3 * n].view(n, 3),
                           screen_pos=floats[scr: scr + 2 * n].view(n, 2))
        scratch = ints[n + 1:]
    if with_aux:
        out = out._replace(extents=torch.empty((n, 4), dtype=torch.int32, device=dev),
                           flags=torch.empty((n,), dtype=torch.uint8, device=dev))
    return out, scratch


def _tensors(table, thr_dilated) -> tuple:
    """The table's tensors and the thresholds (or None): what K7 reads."""
    return (*(getattr(table, name) for name in _TABLE_SHAPES), thr_dilated)


def _launch_project(table, view, proj, cam_pos, config: RenderConfig, capacity=None,
                    thr_dilated=None, *, with_aux=False) -> Projection:
    dev = _build.card_device(*_tensors(table, thr_dilated))
    _check(table, thr_dilated, config)
    n = table.position.shape[0]
    words = _build.load_library().vk3d_keygen_scratch_words(n, config.num_tiles)
    if words < 0:
        raise ValueError(f"{n} gaussians x {config.num_tiles} tiles: past K7's limits (ids in "
                         f"int32, count sums in the look-back's 62-bit status words)")
    position, scale, rot, opacity, sh = (_aligned(t) for t in (
        table.position, table.scale, table.rot, table.opacity, table.sh))
    thr = thr_dilated.contiguous() if thr_dilated is not None else None
    params = keygen_params(view, proj, cam_pos, config)
    out, scratch = _outputs(n, dev, None if capacity is None else words, with_aux)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.launch(
        "keygen_count" if capacity is None else "keygen_project", "vk3d_keygen_project",
        position.data_ptr(), scale.data_ptr(), rot.data_ptr(), opacity.data_ptr(),
        sh.data_ptr(), n, ctypes.addressof(params), ptr(thr),
        out.total.data_ptr(), ptr(out.extents), ptr(out.flags), ptr(out.cols),
        -1 if capacity is None else capacity, ptr(out.cum), ptr(out.color_alpha),
        ptr(out.cov2d), ptr(out.cov_inv), ptr(out.screen_pos), ptr(scratch),
        0 if scratch is None else scratch.numel(), device=dev,
    )
    return out


def project_gaussians(table, view, proj, cam_pos, config: RenderConfig, capacity=None,
                      thr_dilated=None, *, with_aux=False) -> Projection:
    """keygen's per-gaussian pass over the table (K7).

    Args:
      table: GaussianTable of float32 tensors on one device.
      view/proj: [4,4] row-major camera matrices; cam_pos: [3] camera
        position (numpy, taken as float32).
      config: render config (`sh_mode`, the tile grid, the constants).
      capacity: sort capacity E, which clamps the offset row; None is the
        counts mode (`count_live_elements`): only `total`.
      thr_dilated: optional [num_tiles] int64 dilated threshold map
        (prefilter.dilate_thresholds): the prefilter's keep mask ANDs the
        cull.
      with_aux: also return the extents and the visible / keep flags.

    Returns a `Projection`.  CUDA tensors launch K7 (counted as
    "keygen_project", or "keygen_count" in the counts mode); CPU tensors run
    `project_gaussians_plain`.
    """
    if _build.on_card(*_tensors(table, thr_dilated)):
        return _launch_project(table, view, proj, cam_pos, config, capacity, thr_dilated,
                               with_aux=with_aux)
    _check(table, thr_dilated, config)
    return project_gaussians_plain(table, view, proj, cam_pos, config, capacity, thr_dilated,
                                   with_aux=with_aux)


def emitting(p: Projection) -> torch.Tensor:
    """[N] bool: the gaussians whose count is above 0, from `p.cum` (the
    full mode's): the rows whose SH row K7 reads and whose colour it
    evaluates."""
    return torch.diff(p.cum, prepend=p.cum.new_zeros(1)) > 0


def sh_rows_read(p: Projection) -> int:
    """The SH rows K7 read for `p` (the gaussians with a count above 0).
    Reads the device: for checks and tests, off the frame path."""
    return int(emitting(p).sum())


FLOAT_FIELDS = ("color_alpha", "cov2d", "cov_inv", "screen_pos")
INT_FIELDS = ("total", "cum", "cols", "extents", "flags")


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 ulps between a and b, elementwise, as int64: 0 where they are
    equal (-0 == +0) or both NaN."""

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    same = (a == b) | (a.isnan() & b.isnan())
    return torch.where(same, 0, (ordered(a) - ordered(b)).abs())


def projection_mismatch(got: Projection, want: Projection) -> dict:
    """K7's output against its plain version's, field by field: for an
    integer field the number of values that differ; for a float field
    (values that differ, max ulps), NaN equal to NaN.  Fields unset in
    either are left out."""
    out = {}
    for name in INT_FIELDS + FLOAT_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            continue
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{name}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        if name in INT_FIELDS:
            out[name] = int((a != b).sum())
        else:
            d = ulp_distance(a, b)
            out[name] = (int((d > 0).sum()), int(d.max()) if d.numel() else 0)
    return out
