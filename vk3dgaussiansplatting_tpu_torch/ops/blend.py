"""Tiled front-to-back alpha blending — the RenderGaussians pass.

Port of `vk3dgaussiansplatting_tpu.ops.blend`, plus the plain PyTorch
versions of the CUDA blends (ops/cuda/blend_kernel.py): `blend_rows_plain`
(K2, csrc/blend.cu), `blend_flat_plain` (K3, csrc/blend_flat.cu) and
`blend_strip_plain` (K4, csrc/blend_strip.cu, the distributed frame's
carry-aware strip blend).  JAX's log-space `blend_strip_colors_xla` has no
counterpart: `blend_strip_plain` takes its place, as `blend_rows_plain`
takes `blend_tiles_xla`'s.

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


# Batch starts of the JAX flat blend (blend_kernel.py:496): each tile's
# first batch begins at its range start rounded down to this alignment.
ALIGN_K = 128


def blend_flat_plain(
    table: torch.Tensor,
    index: torch.Tensor,
    ranges: torch.Tensor,
    config: RenderConfig,
    *,
    cap: int = 0,
    with_t: bool = False,
):
    """Rank-stepped plain version of K3, the flat blend with the JAX flat
    kernel's transmittance semantics (blend_kernel.py:561-644).

    A tile's range is cut into batches of `config.blend_batch_k` elements
    starting at ⌊start/128⌋·128.  Within a run batch every pixel multiplies
    its T by (1 - alpha) over every eligible element, and contributes colour
    only while its incoming T is still >= transmittance_stop.  Before each
    batch after the first, the tile stops once every one of its 256 pixels
    (those past the image edge included) has T < stop.  The colours equal
    `blend_rows_plain`'s; the carried T is what the capped policy reads.

    Args:
      table: [N, 10] float32 feature rows (pack_feature_table).
      index: [E] int64 gaussian id per slot; SENTINEL, and slots >= E, are
        dead.
      ranges: [num_tiles, 2] int64 (start, end) into `index`.
      cap: > 0 cuts each range to its first `cap` elements.
      with_t: also return the per-pixel outgoing T, [num_tiles, 256] float32
        (1 for tiles with no elements).

    Returns the [H, W, 3] image in [0, 1] (and T with `with_t`).
    """
    num_tiles = config.num_tiles
    p = config.tile_size**2
    if cap:
        ranges = torch.stack([ranges[:, 0], torch.minimum(ranges[:, 1], ranges[:, 0] + cap)], dim=1)
    color, trans = _blend_batched(
        table, index, ranges, config, 0,
        torch.zeros((num_tiles, p, 3), device=table.device),
        torch.ones((num_tiles, p), device=table.device),
        gather=True,
    )
    img = assemble_tile_colors(color, config)
    return (img, trans) if with_t else img


def blend_strip_plain(
    rows: torch.Tensor,
    index: torch.Tensor,
    ranges: torch.Tensor,
    config: RenderConfig,
    *,
    tile_base: int,
    carry_color: torch.Tensor,
    carry_logt: torch.Tensor,
    gather: bool = False,
):
    """Rank-stepped plain version of K4, the distributed frame's
    carry-aware strip blend (the JAX `blend_strip_colors_pallas`,
    blend_kernel.py:808, its `_blend_tile_kernel` with `with_carry`).

    Strip tile i is the global tile `tile_base + i` (its pixel coordinates
    come from that id).  It starts from the incoming colour and
    T = exp(carry_logt), blends its [start, end) of the slots with K3's
    batch-granular T (ops/blend.py:blend_flat_plain), and stops before any
    batch, the first included, once all 256 pixels have T < stop: a tile
    whose carry is already saturated passes colour and T through.

    Args:
      rows: [E, 10] float32 feature rows (pack_feature_table's columns), one
        per slot; with `gather`, the [N, 10] per-gaussian table instead.
      index: [E] int64 gaussian id per slot (SENTINEL, and slots >= E, are
        dead); with `gather` the row of slot k is rows[index[k]].
      ranges: [T_s, 2] int64 (start, end) of each strip tile into the slots.
      tile_base: global id of the strip's first tile.
      carry_color: [T_s, 256, 3] float32 colour entering the strip.
      carry_logt: [T_s, 256] float32 log transmittance entering it.

    Returns (colors [T_s, 256, 3] unclipped, logt_end [T_s, 256]); logt_end
    is -inf where T reached 0.
    """
    color, trans = _blend_batched(
        rows, index, ranges, config, tile_base,
        carry_color.clone(), torch.exp(carry_logt), gather=gather,
    )
    return color, torch.log(trans)


def _blend_batched(rows, index, ranges, config, tile_base, color, trans, *, gather):
    """The rank-stepped loop of K3's and K4's plain versions: blends each
    tile's range into `color` [T, 256, 3] and `trans` [T, 256] (both updated
    in place and returned) with the TPU kernels' batch-granular T."""
    device = rows.device
    ts = config.tile_size
    p = ts * ts
    stop = config.transmittance_stop
    cutoff = config.alpha_cutoff
    bk = config.blend_batch_k
    e = index.shape[0]
    num_tiles = ranges.shape[0]

    tiles = tile_base + torch.arange(num_tiles, device=device)
    pix = torch.arange(p, device=device)
    # Pixel p = v*ts + u of tile t (the GLSL local index layout).
    px = ((tiles % config.grid_width)[:, None] * ts + pix % ts).float()
    py = ((tiles // config.grid_width)[:, None] * ts + pix // ts).float()

    start = ranges[:, 0]
    length = torch.clamp(ranges[:, 1] - start, min=0)
    astart = torch.div(start, ALIGN_K, rounding_mode="floor") * ALIGN_K
    stopped = torch.zeros(num_tiles, dtype=torch.bool, device=device)

    max_len = int(length.max()) if num_tiles else 0
    for r in range(max_len):
        k = start + r
        # Before every batch: leave once all 256 pixels are below the stop.
        boundary = (r < length) & ((torch.remainder(k - astart, bk) == 0) | (r == 0))
        stopped |= boundary & (trans.amax(dim=1) < stop)
        act = torch.nonzero((r < length) & ~stopped).squeeze(1)
        if act.numel() == 0:
            break
        kk = k[act]
        idx = index[torch.clamp(kk, max=e - 1)]
        live = (kk < e) & (idx != SENTINEL)
        if gather:
            row = rows[torch.where(live, idx, 0)]  # [A, 10]
        else:  # a dead slot's row may hold anything: read it as zeros
            row = torch.where(live[:, None], rows[torch.clamp(kk, max=e - 1)], 0.0)
        gx, gy, a, b, c = (row[:, j : j + 1] for j in range(5))
        galpha = torch.where(live, row[:, 9], 0.0)[:, None]

        dx = gx - px[act]
        dy = py[act] - gy
        f = (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = galpha * torch.exp(f)
        t_act = trans[act]
        elig = (f <= 0.0) & (alpha >= cutoff)
        w = torch.where(elig & (t_act >= stop), t_act * alpha, 0.0)
        color[act] += w[:, :, None] * row[:, None, 6:9]
        trans[act] = torch.where(elig, t_act * (1.0 - alpha), t_act)
    return color, trans


def quantize_image(img: torch.Tensor) -> torch.Tensor:
    """float [H,W,3] in [0,1] -> uint8 rgba, matching rgba8 unorm imageStore
    (round half to even) with alpha = 255 (RenderGaussians.comp:146-151)."""
    rgb = torch.round(img * 255.0).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=img.device)
    return torch.cat([rgb, alpha], dim=-1)
