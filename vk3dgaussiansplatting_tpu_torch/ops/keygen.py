"""Sort-key generation — the InitSortList pass.

Port of `vk3dgaussiansplatting_tpu.ops.keygen`.  The reference kernel
(InitSortList.comp) allocates one sort element per overlapped tile with an
`atomicAdd` on a global counter (InitSortList.comp:131).  As in the JAX
package, the allocation is a deterministic prefix-sum plan instead:

  1. per-gaussian overlap counts  c_i = w_i * h_i   (0 if culled)
  2. exclusive scan               off_i = sum_{k<i} c_k
  3. fixed-capacity expansion     slot e in [0, E) belongs to gaussian
                                  g(e) = repeat(arange(N), counts)[e]

so slot order is gaussians in index order, tiles row-major within each
(InitSortList.comp:133-150), elements past the capacity E are dropped
(InitSortList.comp:143) and unused slots hold the 0xFFFFFFFF sentinel
(Subrenderer.cpp:42-46).

Integer types: tile, depth and index are int64 tensors holding the uint32
values of the JAX package (SENTINEL included); the scan is int64, where JAX's
is int32 and would wrap past 2^31 elements.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import SENTINEL, RenderConfig
from ..render import project
from ..utils.timing import section
from .cuda import expand_kernel

EXPANSION_METHODS = ("auto", "pallas", "stream", "repeat")


class SortElements(NamedTuple):
    """Flat sort-element list of capacity E, sentinel-padded.

    tile:  [E] int64 tile key (SENTINEL for unused slots)
    depth: [E] int64 depth key in [0, 2^32) (SENTINEL for unused slots)
    index: [E] int64 source gaussian index (SENTINEL for unused slots)
    count: []  int64 live elements (the reference's
           cullData.numGaussiansToRender.x, clamped to the capacity)
    """

    tile: torch.Tensor
    depth: torch.Tensor
    index: torch.Tensor
    count: torch.Tensor


class GaussianFrameData(NamedTuple):
    """Per-gaussian frame intermediates (InitSortList.comp:123-127 write-back
    plus the screen position RenderGaussians recomputes).

    color_alpha: [N,4] SH colour rgb + opacity (0 where det(cov2d) == 0)
    cov2d:       [N,3] 2D covariance (upper triangle)
    cov_inv:     [N,3] inverse 2D covariance (RenderGaussians.comp:94-105)
    screen_pos:  [N,2] pixel-space position
    """

    color_alpha: torch.Tensor
    cov2d: torch.Tensor
    cov_inv: torch.Tensor
    screen_pos: torch.Tensor


def cull_mask(pos_view, ndc, config: RenderConfig) -> torch.Tensor:
    """Near-plane + NDC-margin culling (InitSortList.comp:92-101)."""
    near_ok = -pos_view[:, 2] > float(np.float32(config.near_plane))
    lim = float(np.float32(config.culling_ndc_limit))
    return near_ok & (ndc[:, 0].abs() <= lim) & (ndc[:, 1].abs() <= lim)


def _frame_geometry(table, view, proj, config):
    """View transform, cull, depth keys, EWA covariance, screen position and
    tile extents: the projection half of InitSortList, shared by
    generate_sort_elements and count_live_elements so the two cannot
    drift apart."""
    pos_view = project.view_transform(table.position, view)
    ndc = project.ndc_position(pos_view, proj)
    visible = cull_mask(pos_view, ndc, config)
    depth = project.depth_key(pos_view[:, 2], config)
    cov2d = project.compute_cov2d(table.scale, table.rot, pos_view, view, config)
    screen_pos = project.screen_space_position(pos_view, proj, config)
    extents = project.tile_extents(screen_pos, cov2d, config)
    return pos_view, visible, depth, cov2d, screen_pos, extents


def _check_no_prefilter(depth_thr) -> None:
    if depth_thr is not None:
        raise NotImplementedError(
            "the depth-threshold prefilter belongs to the capped path "
            "(ROADMAP slice 2, A10) and is not ported yet"
        )


def count_live_elements(table, view, proj, cam_pos, config, depth_thr=None):
    """Live sort-element count without the expansion, as a [] int64 tensor."""
    _check_no_prefilter(depth_thr)
    _pv, visible, _d, _c2, _sp, extents = _frame_geometry(table, view, proj, config)
    counts = (extents[:, 2] - extents[:, 0]) * (extents[:, 3] - extents[:, 1])
    return torch.where(visible, counts, 0).sum()


def generate_sort_elements(
    table,
    view: np.ndarray,
    proj: np.ndarray,
    cam_pos: np.ndarray,
    config: RenderConfig,
    capacity: int,
    depth_thr=None,
    *,
    use_kernels: bool = True,
    timer=None,
):
    """Full InitSortList pass over the gaussian table.

    Args:
      table: GaussianTable of tensors on one device.
      view/proj: [4,4] float32 row-major camera matrices (numpy).
      cam_pos: [3] float32 camera world position (numpy).
      config: render config.
      capacity: sort-element capacity E.
      depth_thr: the capped path's prefilter; not ported (raises).
      use_kernels: False forces the expansion's plain version, as
        `expansion_method="repeat"` does.
      timer: optional utils.timing.CudaPassTimer; times the expansion as
        "expand".

    Returns (SortElements, GaussianFrameData).
    """
    _check_no_prefilter(depth_thr)
    if config.expansion_method not in EXPANSION_METHODS:
        raise ValueError(f"unknown expansion_method {config.expansion_method!r}")
    device = table.position.device
    pos = table.position
    n = pos.shape[0]

    pos_view, visible, depth, cov2d, screen_pos, extents = _frame_geometry(
        table, view, proj, config
    )

    # SH colour (InitSortList.comp:122-126).
    cam = torch.as_tensor(np.asarray(cam_pos, np.float32), device=device)
    to_gauss = project.normalize_dirs(pos - cam[None, :])
    rgb = project.sh_color(to_gauss, table.sh, config.sh_mode)

    # Inverse 2D covariance (RenderGaussians.comp:94-105): a zero determinant
    # zeroes the alpha instead.
    det = project._fma(cov2d[:, 0], cov2d[:, 2], -(cov2d[:, 1] * cov2d[:, 1]))
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / det, 0.0)
    cov_inv = torch.stack([cov2d[:, 2], -cov2d[:, 1], cov2d[:, 0]], dim=-1) * det_inv[:, None]
    alpha = torch.where(det_ok, table.opacity, 0.0)
    color_alpha = torch.cat([rgb, alpha[:, None]], dim=-1)

    # --- element allocation (a scan replaces atomicAdd) -------------------
    w = extents[:, 2] - extents[:, 0]
    h = extents[:, 3] - extents[:, 1]
    counts = torch.where(visible, w * h, 0)
    offsets = torch.cumsum(counts, 0) - counts  # exclusive, int64
    # Column values are int32 (the kernel's row format).  Only rows with
    # offset < capacity are read, so clamping the offset loses nothing; the
    # depth key rides as its int32 bit pattern.
    packed_cols = torch.stack(
        [
            torch.arange(n, device=device, dtype=torch.int64),
            offsets.clamp(max=capacity),
            w.clamp(min=1),
            extents[:, 0],
            extents[:, 1],
            torch.where(depth >= 2**31, depth - 2**32, depth),
        ]
    ).to(torch.int32)
    with section(timer, "expand"):
        if use_kernels and config.expansion_method != "repeat":
            cols, total = expand_kernel.expand_rows(packed_cols, counts, capacity)
        else:
            cols, total = expand_kernel.expand_rows_plain(packed_cols, counts, capacity)

    cols = cols.to(torch.int64)
    slot = torch.arange(capacity, device=device, dtype=torch.int64)
    count = torch.clamp(total, max=capacity)
    live = slot < count
    local = slot - cols[1]
    gw_safe = cols[2].clamp(min=1)  # dead slots hold zero rows
    ly = torch.div(local, gw_safe, rounding_mode="floor")
    lx = local - ly * gw_safe
    tile_key = (cols[4] + ly) * config.grid_width + (cols[3] + lx)

    elements = SortElements(
        tile=torch.where(live, tile_key, SENTINEL),
        depth=torch.where(live, cols[5] & 0xFFFFFFFF, SENTINEL),
        index=torch.where(live, cols[0], SENTINEL),
        count=count,
    )
    frame = GaussianFrameData(
        color_alpha=color_alpha,
        cov2d=cov2d,
        cov_inv=cov_inv,
        screen_pos=screen_pos,
    )
    return elements, frame
