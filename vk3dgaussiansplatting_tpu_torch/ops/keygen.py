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

Where it runs: on the card the per-gaussian pass and the scan are one
kernel, K7 (`cuda/keygen_kernel.project_gaussians`, csrc/keygen.cu: the
offset row, the inclusive scan `cum` and the total), then K1 or K1'
(`cuda/expand_kernel.expand_elements`, csrc/expand.cu) expands the rows
over K7's `cum` and, in its store phase, decodes each slot into its sort
element: the elements are written once and the rows never reach device
memory.  No PyTorch kernel runs between the two.  On CPU tensors the same
wrappers run their plain versions (`project_gaussians_plain`, the float32
torch code of render/project.py with `torch.cumsum`, and
`decode_slots_plain` over `expand_rows_plain`).
Nothing on the card falls back to a plain version: a failed build or
launch raises.

With `depth_order` (the frame's radix path, ops/sort.py `depth_first`) the
rows go through `cuda/radix_kernel.depth_order` between K7 and K1: the
gaussians that keep a slot, in the stable order of their depth keys, each
with the slots it keeps in the index-order expansion.  The list then holds
the same elements and count in (depth, id) order, each gaussian's tiles
row-major, and the sort keys the tile alone.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import RenderConfig
from ..utils.timing import section
from . import prefilter
from .cuda import expand_kernel, keygen_kernel, radix_kernel

EXPANSION_METHODS = ("auto", "pallas", "stream", "repeat")


class SortElements(NamedTuple):
    """Flat sort-element list of capacity E, sentinel-padded.

    tile:  [E] int64 tile key (SENTINEL for unused slots)
    depth: [E] int64 depth key in [0, 2^32) (SENTINEL for unused slots);
           None after the uncapped frame's sort, which carries no depth
           (ops/sort.py)
    index: [E] int64 source gaussian index (SENTINEL for unused slots)
    count: []  int64 live elements (the reference's
           cullData.numGaussiansToRender.x, clamped to the capacity)
    """

    tile: torch.Tensor
    depth: torch.Tensor | None
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


def count_live_elements(table, view, proj, cam_pos, config, depth_thr=None):
    """Live sort-element count without the expansion (projection, extents
    and the optional prefilter only), as a [] int64 tensor: the steady
    switch's feasibility probe (pipeline.ChainedTemporalPlan) and the
    calibration's count.  K7 in its counts mode on the card, one launch."""
    thr = None if depth_thr is None else prefilter.dilate_thresholds(depth_thr, config)
    return keygen_kernel.project_gaussians(table, view, proj, cam_pos, config, None, thr).total


def generate_sort_elements(
    table,
    view: np.ndarray,
    proj: np.ndarray,
    cam_pos: np.ndarray,
    config: RenderConfig,
    capacity: int,
    depth_thr=None,
    *,
    depth_order: bool = False,
    timer=None,
):
    """Full InitSortList pass over the gaussian table.

    The expansion and decode are the plain version for
    `expansion_method="repeat"`, else `expand_elements`: K1, or K1' for
    "stream" and, under a `depth_thr`, for "pallas" and "auto" (the JAX
    dispatch, keygen.py:217-238).

    Args:
      table: GaussianTable of tensors on one device.
      view/proj: [4,4] float32 row-major camera matrices (numpy).
      cam_pos: [3] float32 camera world position (numpy).
      config: render config.
      capacity: sort-element capacity E.
      depth_thr: optional [num_tiles] int64 depth-threshold map
        (ops/prefilter.py): gaussians provably behind every touched tile's
        threshold emit no elements.  None, or an all-SENTINEL map, gives the
        unfiltered list bit for bit.
      depth_order: expand the rows in depth order (`radix_kernel.depth_order`,
        timed as "depth_order"): the same elements and count, in (depth,
        id) order, for a sort on the tile alone; else in index order, as
        the JAX package's list.
      timer: optional utils.timing.CudaPassTimer; spans K7 as "project"
        (host-only: its device time is read by launch from the device
        trace) and times the expansion and decode as "expand".

    Returns (SortElements, GaussianFrameData).
    """
    if config.expansion_method not in EXPANSION_METHODS:
        raise ValueError(f"unknown expansion_method {config.expansion_method!r}")
    thr = None if depth_thr is None else prefilter.dilate_thresholds(depth_thr, config)
    with section(timer, "project"):
        p = keygen_kernel.project_gaussians(table, view, proj, cam_pos, config, capacity, thr)
    cols, cum = p.cols, p.cum
    if depth_order:
        with section(timer, "depth_order"):
            cols, cum = radix_kernel.depth_order(cols, cum, capacity, config.grid_width,
                                                 config.grid_height)
    method = config.expansion_method
    with section(timer, "expand"):
        if method == "repeat":
            out = expand_kernel.expand_elements_plain(cols, cum, capacity, config.grid_width)
        else:
            out = expand_kernel.expand_elements(
                cols, cum, capacity, config.grid_width,
                streamed=method == "stream" or depth_thr is not None)

    elements = SortElements(*out)
    frame = GaussianFrameData(p.color_alpha, p.cov2d, p.cov_inv, p.screen_pos)
    return elements, frame
