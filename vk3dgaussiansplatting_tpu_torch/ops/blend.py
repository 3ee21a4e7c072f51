"""Tiled front-to-back alpha blending — the RenderGaussians pass.

Port of `vk3dgaussiansplatting_tpu.ops.blend`.  The blends' entry points
are `blend_tiles` (K2, csrc/blend.cu), `blend_flat` (K3, csrc/blend_flat.cu)
and `blend_strip` (K4, csrc/blend_strip.cu, the distributed frame's
carry-aware strip blend): each launches its CUDA kernel
(ops/cuda/blend_kernel.py) for CUDA tensors and runs its plain PyTorch
version here for CPU tensors (`blend_rows_plain`, `blend_flat_plain`,
`blend_strip_plain`, reading `pack_feature_table`'s rows); none falls back
from one to the other.  JAX's log-space `blend_strip_colors_xla` has no
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
from .cuda import _build, blend_kernel
from .cuda.blend_kernel import ALIGN_K
from .keygen import GaussianFrameData, SortElements


def pack_feature_table(frame: GaussianFrameData) -> torch.Tensor:
    """Per-gaussian blend-feature rows [N, 10] float32:
    [gx, gy, a', b', c', 0, r, g, b, galpha].

    The inverse covariance is pre-scaled (a' = -a/2, b' = -b, c' = -c/2) so
    f = a'dx^2 + c'dy^2 + b'dxdy directly; scaling by powers of two is exact,
    so this equals the GLSL -0.5(a dx^2 + c dy^2) - b dx dy
    (RenderGaussians.comp:117-124) bit for bit."""
    ci = frame.cov_inv
    # Scalar multiplies: a scale vector made on the device would cost a
    # host-synchronising copy per frame.
    cov_scaled = torch.stack([ci[:, 0] * -0.5, ci[:, 1] * -1.0, ci[:, 2] * -0.5], dim=-1)
    zeros = torch.zeros_like(frame.screen_pos[:, :1])
    return torch.cat(
        [frame.screen_pos, cov_scaled, zeros, frame.color_alpha], dim=-1
    ).contiguous()


def blend_tiles(
    elements: SortElements,
    ranges: torch.Tensor,
    frame: GaussianFrameData,
    config: RenderConfig,
) -> torch.Tensor:
    """K2: blend all tiles of a sorted frame (blend_tiles_pallas's
    signature); returns float32 [H, W, 3] in [0, 1].

    The kernel reads frame.screen_pos [N, 2], frame.cov_inv [N, 3] and
    frame.color_alpha [N, 4] (contiguous float32) by the sorted gaussian ids
    elements.index [E] int64 (SENTINEL if dead); ranges: [num_tiles, 2]
    int64.  On CPU tensors: blend_rows_plain on pack_feature_table(frame)."""
    if _build.on_card(*frame, elements.index, ranges):
        return blend_kernel.blend_tiles(frame, elements.index, ranges, config)
    blend_kernel.check_frame(frame, elements.index, ranges, config)
    return blend_rows_plain(pack_feature_table(frame), elements.index, ranges, config)


def blend_flat(
    frame: GaussianFrameData,
    index: torch.Tensor,
    ranges: torch.Tensor,
    config: RenderConfig,
    *,
    cap: int = 0,
    with_t: bool = False,
):
    """K3: blend every tile's [start, end) of `index` with the TPU flat
    kernel's transmittance semantics (blend_flat_plain).

    The kernel reads frame.screen_pos [N, 2], frame.cov_inv [N, 3] and
    frame.color_alpha [N, 4] (contiguous float32, as K2) by the gaussian ids
    index [E] int64 (SENTINEL, and slots >= E, are dead); ranges:
    [num_tiles, 2] int64; cap > 0 cuts each range to its first `cap`
    elements.  Returns the [H, W, 3] float32 image in [0, 1], and with
    `with_t` also the per-pixel outgoing transmittance [num_tiles, 256]
    float32; the kernel's equal the plain version's bit for bit.  On CPU
    tensors: blend_flat_plain on pack_feature_table(frame)."""
    if _build.on_card(*frame, index, ranges):
        return blend_kernel.blend_flat(frame, index, ranges, config, cap=cap, with_t=with_t)
    blend_kernel.check_flat(frame, index, ranges, config, cap)
    return blend_flat_plain(pack_feature_table(frame), index, ranges, config, cap=cap,
                            with_t=with_t)


def blend_strip(
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
    """K4: blend strip tiles [tile_base, tile_base + T_s) from the incoming
    (colour, log T) carry (blend_strip_plain has the semantics).

    rows: [E, 10] float32 rows in slot order, or with `gather` the [N, 10]
    per-gaussian table read by `index` (pack_feature_table's columns,
    8-byte aligned on the card); index: [E] int64 gaussian ids (SENTINEL,
    and slots >= E, are dead); ranges: [T_s, 2] int64 into the slots;
    carry_color: [T_s, 256, 3] float32; carry_logt: [T_s, 256] float32.
    Returns (colors [T_s, 256, 3] unclipped, logt_end [T_s, 256]); on the
    card log T may differ where T is below the stop
    (ops/cuda/blend_kernel.py:blend_strip)."""
    kw = dict(tile_base=tile_base, carry_color=carry_color, carry_logt=carry_logt, gather=gather)
    if _build.on_card(rows, index, ranges, carry_color, carry_logt):
        return blend_kernel.blend_strip(rows, index, ranges, config, **kw)
    blend_kernel.check_strip(rows, index, ranges, config, **kw)
    return blend_strip_plain(rows, index, ranges, config, **kw)


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


# csrc/blend_rows.cuh's kSkipMargin, kMaskMargin, kMinConic and kWarps.
SKIP_MARGIN = 1e-3
MASK_MARGIN = 2.0**-16
MIN_CONIC = 1e-30
WARPS = 8
# K2's warps (csrc/blend_rows.cuh:warp_pixel): warp w covers the tile's
# columns 8(w % 2) .. + 7 and rows 4(w // 2) .. + 3; WARP_PIXELS[w, l] is
# lane l's pixel v * 16 + u.
_LANE = torch.arange(32)
WARP_PIXELS = torch.stack([(4 * (w // 2) + _LANE // 8) * 16 + 8 * (w % 2) + _LANE % 8
                           for w in range(WARPS)])


def warp_masks_plain(rows: torch.Tensor, tiles: torch.Tensor, config: RenderConfig
                     ) -> torch.Tensor:
    """K2's warp mask of each row (csrc/blend_rows.cuh:warp_mask), in the
    kernel's float32 arithmetic and order, without its FMA contraction and
    with an exact division for the kernel's fast one.

    rows: [R, 10] float32 feature rows (pack_feature_table's columns; a
    dead row's galpha is 0); tiles: [R] int64, the tile each row is
    blended in.  Returns [R] uint8: bit w is set unless f < thr at every
    pixel of warp w (WARP_PIXELS[w]), judged by f's largest value on each
    of its four pixel rows (at the vertex clamped to its eight columns)
    against thr less MASK_MARGIN times the size of f's terms.  thr > 0
    (dead rows) gives 0; a conic that is not negative definite or has
    |a'| < MIN_CONIC, a non-finite value or a margin out of float range
    gives 0xFF."""
    f32 = dict(dtype=torch.float32, device=rows.device)
    ts = config.tile_size
    x0 = ((tiles % config.grid_width) * ts).to(torch.float32)
    y0 = ((tiles // config.grid_width) * ts).to(torch.float32)
    gx, gy, a, b, c, galpha = (rows[:, k] for k in (0, 1, 2, 3, 4, 9))
    thr = torch.log(torch.tensor(config.alpha_cutoff, **f32) / galpha) - SKIP_MARGIN
    lo, hi = gx - (x0 + (ts - 1)), gx - x0
    mid_l, mid_r = gx - (x0 + 7), gx - (x0 + 8)
    e = (y0[:, None] + torch.arange(ts, **f32)) - gy[:, None]  # dy of each pixel row
    mx = torch.maximum(lo.abs(), hi.abs())
    my = torch.maximum(e[:, 0].abs(), e[:, -1].abs())
    lim = thr - MASK_MARGIN * ((b.abs() * my - a * mx) * mx - c * my * my)
    a_, b_, c_ = a[:, None], b[:, None], c[:, None]
    v, be, ce2 = (-0.5 * b / a)[:, None] * e, b_ * e, c_ * e * e

    def peak(lo, hi):  # [R, 4 bands]; fminf/fmaxf: a NaN operand is dropped
        dx = torch.fmin(torch.fmax(v, lo[:, None]), hi[:, None])
        p = (a_ * dx + be) * dx + ce2
        return torch.fmax(torch.fmax(p[:, 0::4], p[:, 1::4]), torch.fmax(p[:, 2::4], p[:, 3::4]))

    peaks = torch.stack([peak(mid_l, hi), peak(lo, mid_r)], dim=2).reshape(-1, WARPS)
    keep = ~(peaks < lim[:, None])
    mask = (keep.to(torch.int32) << torch.arange(WARPS, device=rows.device)).sum(dim=1)
    mask = torch.where(lim > -1e30, mask, 0xFF)  # also any non-finite value
    definite = (a < -MIN_CONIC) & (c < 0) & (4.0 * a * c > b * b)
    mask = torch.where(definite, mask, 0xFF)
    return torch.where(thr > 0, 0, mask).to(torch.uint8)


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
