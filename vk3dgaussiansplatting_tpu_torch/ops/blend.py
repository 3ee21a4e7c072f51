"""Tiled front-to-back alpha blending — the RenderGaussians pass.

Port of `vk3dgaussiansplatting_tpu.ops.blend`, plus the blend's plain
PyTorch version, `blend_rows_plain`, which the CUDA blend kernel
(ops/cuda/blend_kernel.py, csrc/blend.cu) is held against.

The reference (RenderGaussians.comp) gives each 16x16 tile one thread group
and runs, per pixel, over the tile's sorted range:

    eligible: f <= 0 and alpha >= 1/255         (:119-128)
    color += T * alpha * rgb                    (:131)
    T     *= (1 - alpha), stop when T < 1e-4    (:133-142)

`blend_rows_plain` runs exactly that recurrence, but rank-stepped: step r
processes element start_t + r of every tile at once on [tiles, 256] tensors,
with the kernel's association, and stops once every tile is exhausted or
saturated.  Its memory is O(tiles * 256), so unlike the JAX package's
O(E * 256) `blend_tiles_xla` it runs at full scene size on the card.
"""

from __future__ import annotations

import torch

from ..core.config import SENTINEL, RenderConfig
from .keygen import GaussianFrameData, SortElements

# Columns of the per-gaussian feature table (ops/cuda/blend_kernel.py
# pack_feature_table): gx, gy, a' = -a/2, b' = -b, c' = -c/2, 0, r, g, b,
# galpha.
NUM_TABLE_COLS = 10


def gather_element_features(elements: SortElements, frame: GaussianFrameData):
    """Per-gaussian frame data in sorted-element order:
    (screen_pos [E,2], color_alpha [E,4], cov_inv [E,3]); sentinel slots read
    gaussian 0."""
    idx = torch.where(elements.index == SENTINEL, 0, elements.index)
    return frame.screen_pos[idx], frame.color_alpha[idx], frame.cov_inv[idx]


def assemble_tile_colors(tile_colors: torch.Tensor, config: RenderConfig) -> torch.Tensor:
    """[num_tiles, P, 3] per-tile pixels -> clipped [H, W, 3] image."""
    gh, gw, ts = config.grid_height, config.grid_width, config.tile_size
    img = tile_colors.reshape(gh, gw, ts, ts, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(gh * ts, gw * ts, 3)
    img = img[: config.height, : config.width]
    return torch.clamp(img, 0.0, 1.0)


def blend_rows_plain(
    table: torch.Tensor, index: torch.Tensor, ranges: torch.Tensor, config: RenderConfig
) -> torch.Tensor:
    """Rank-stepped sequential blend; returns float32 [H, W, 3] in [0, 1].

    Args:
      table: [N, 10] float32 per-gaussian feature rows (pack_feature_table).
      index: [E] int64 sorted gaussian index per element (SENTINEL if dead).
      ranges: [num_tiles, 2] int64 (start, end) per tile.
    """
    device = table.device
    ts = config.tile_size
    p = ts * ts
    num_tiles = config.num_tiles
    stop = config.transmittance_stop
    cutoff = config.alpha_cutoff

    tiles = torch.arange(num_tiles, device=device)
    pix = torch.arange(p, device=device)
    # Pixel p = v*ts + u of tile t (the GLSL local index layout).
    px = ((tiles % config.grid_width)[:, None] * ts + pix % ts).float()
    py = ((tiles // config.grid_width)[:, None] * ts + pix // ts).float()

    start = ranges[:, 0]
    length = ranges[:, 1] - ranges[:, 0]
    trans = torch.ones((num_tiles, p), device=device)
    color = torch.zeros((num_tiles, p, 3), device=device)
    done = torch.zeros((num_tiles, p), dtype=torch.bool, device=device)

    max_len = int(length.max()) if num_tiles else 0
    for r in range(max_len):
        act = torch.nonzero((r < length) & ~done.all(dim=1)).squeeze(1)
        if act.numel() == 0:
            break
        idx = index[start[act] + r]
        live = idx != SENTINEL
        row = table[torch.where(live, idx, 0)]  # [A, 10]
        gx, gy, a, b, c = (row[:, k : k + 1] for k in range(5))
        galpha = torch.where(live, row[:, 9], 0.0)[:, None]

        dx = gx - px[act]
        dy = py[act] - gy
        f = (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = galpha * torch.exp(f)
        t_act = trans[act]
        elig = (f <= 0.0) & (alpha >= cutoff) & ~done[act]
        w = torch.where(elig, t_act * alpha, 0.0)
        color[act] += w[:, :, None] * row[:, None, 6:9]
        t_new = torch.where(elig, t_act * (1.0 - alpha), t_act)
        trans[act] = t_new
        done[act] |= t_new < stop
    return assemble_tile_colors(color, config)


def quantize_image(img: torch.Tensor) -> torch.Tensor:
    """float [H,W,3] in [0,1] -> uint8 rgba, matching rgba8 unorm imageStore
    (round half to even) with alpha = 255 (RenderGaussians.comp:146-151)."""
    rgb = torch.round(img * 255.0).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=img.device)
    return torch.cat([rgb, alpha], dim=-1)
