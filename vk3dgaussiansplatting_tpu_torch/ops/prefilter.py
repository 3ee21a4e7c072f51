"""Temporal depth prefilter — port of `vk3dgaussiansplatting_tpu.ops.prefilter`.

Keygen drops gaussians that lie provably behind every tile they touch: a
per-tile depth-key threshold map (published by the capped blend's policy,
ops/capped.py) is dilated to a (2R+1)² neighbourhood max, and a gaussian
whose tile rect fits inside its centre tile's neighbourhood and whose depth
key exceeds that max emits no elements.  Every dropped element of tile t
then has depth > thresholds[t], so tile t's kept range holds every element
up to its threshold (the conservativeness argument of the JAX module).

Thresholds are int64 tensors holding uint32 depth keys; SENTINEL disables
filtering for a tile.
"""

from __future__ import annotations

import torch

from ..core.config import SENTINEL, RenderConfig
from ..render.project import _xla_f32_to_i32

# Dilation radius in tiles: rects up to (2R+1) x (2R+1) around the centre
# tile are filterable; bigger gaussians bypass the filter.
RADIUS = 2


def init_thresholds(config: RenderConfig, device=None) -> torch.Tensor:
    """All-SENTINEL threshold map: filtering disabled everywhere."""
    return torch.full((config.num_tiles,), SENTINEL, dtype=torch.int64, device=device)


def dilate_thresholds(thr: torch.Tensor, config: RenderConfig, radius: int = RADIUS):
    """[T] -> [T] max over the (2r+1)² tile neighbourhood, clipped at the
    grid's edges (a separable running max, as in the JAX package)."""
    m = thr.reshape(config.grid_height, config.grid_width)
    for dim in (0, 1):
        size = m.shape[dim]
        acc = m
        for s in range(1, radius + 1):
            idx = torch.arange(size, device=thr.device)
            lo = m.index_select(dim, torch.clamp(idx + s, max=size - 1))
            hi = m.index_select(dim, torch.clamp(idx - s, min=0))
            acc = torch.maximum(acc, torch.maximum(lo, hi))
        m = acc
    return m.reshape(-1)


def gaussian_keep_mask(
    screen_pos, extents, depth, thr_dilated, config: RenderConfig, radius: int = RADIUS
) -> torch.Tensor:
    """[N] bool: False only for gaussians whose depth key is beyond every
    touched tile's threshold.

    screen_pos [N, 2] float32 pixel centres; extents [N, 4] int64 tile rects
    (x0, y0, x1, y1), half-open; depth [N] int64 depth keys; thr_dilated
    [T] int64 (dilate_thresholds)."""
    gw, gh = config.grid_width, config.grid_height
    ts = float(config.tile_size)
    # XLA's saturating float->int cast (NaN -> 0), not torch's (ROADMAP §C).
    cx = torch.clamp(_xla_f32_to_i32(screen_pos[:, 0] / ts), 0, gw - 1)
    cy = torch.clamp(_xla_f32_to_i32(screen_pos[:, 1] / ts), 0, gh - 1)
    coverable = (
        (extents[:, 0] >= cx - radius)
        & (extents[:, 2] <= cx + radius + 1)
        & (extents[:, 1] >= cy - radius)
        & (extents[:, 3] <= cy + radius + 1)
    )
    d = thr_dilated[cy * gw + cx]
    return ~coverable | (depth <= d)
