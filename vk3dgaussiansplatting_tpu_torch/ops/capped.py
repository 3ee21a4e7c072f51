"""Saturation-truncated blend with temporal per-tile caps — port of
`vk3dgaussiansplatting_tpu.ops.capped`.

Each tile is blended over only its first `cap_t` sorted elements, on a
packed layout that holds just those elements; the tile is exact when its
range fit the cap or every one of its pixels saturated (T below
transmittance_stop x cap_validation_factor) at the cap.  The per-tile caps,
depth-prefilter thresholds and decay floors (`CapsState`) are carried
across frames and updated from this frame's validation (`_policy_update`).
Tiles that fail are re-blended at full range by the bounded patch pass, and
a frame beyond the patch budgets takes the full uncapped blend.  The JAX
module's docstring and comments give the rationale of every rule; this port
keeps the rules and their order exactly, and the parity tests hold the
state (caps, thresholds, floors), the ok flag and the stats to the JAX
package's frame by frame.

What differs from the JAX module, and why:

  * Kernels.  The layout's ids come from K5 (`compact_slabs`: each tile
    writes its own slab, ids on its live lanes and SENTINEL elsewhere, so
    no chunk map and no mask pass follow it), the blend is K3
    (`blend_flat`); their wrappers run the plain versions on CPU tensors.  K3 reads each packed
    element's float32 row of the frame data (screen_pos, cov_inv,
    color_alpha) by gaussian id itself, so no feature table is built: the
    JAX path's two width-4 tables, its float16 rgb and the [16, ep] feature
    array of `capped_gather` are gone; `capped_gather` has no
    counterpart.
  * Branches.  JAX picks fast path / patch / full fallback with `lax.cond`
    on device scalars.  Here one fetch of (ok, patchable) per frame decides
    on the host: the frame's one deliberate host synchronisation.  The
    threshold-crossing search runs unconditionally (its result is the same
    when no tile is filtered).
  * Integers.  uint32/int32 values are int64 tensors (no wrap anywhere:
    `thr * 2` only runs below SENTINEL/2); the one-hot matmul of the patch
    pass is a scatter-add with the same sums.
  * Overflow frames.  A packed layout larger than ep: the TPU flat
    schedule clips its batch offsets there, K3 treats slots past the layout
    as dead; the frame is flagged (fits = False) and takes the full blend in
    both.  A sort list filled to capacity: FindRanges' quirk can give a
    tile end < start, whose negative length JAX carries into its slab sums
    (and its expansion counts); the port clamps the length at 0, so the
    tile is empty in the layout, validates as JAX's does, and only the
    packed size of such a frame (flagged as an overflow by the chained
    plan) can differ.
  * One frame path.  `blend_tiles_capped_temporal` and
    `blend_tiles_capped_split` are the same code (the JAX split exists for
    the TPU compiler); the split also returns the stats vector.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.config import SENTINEL, RenderConfig
from ..utils.timing import read_back, section
from . import blend as blend_ops
from .cuda import compact_kernel
from .keygen import GaussianFrameData, SortElements
from .search import two_level_lex_search

SEG_ALIGN = 128  # packed per-tile segment alignment

# Bounded patch pass budgets (JAX capped.py:550-565): up to PATCH_TILES
# invalid tiles, each with a range <= PATCH_WMAX - 128, are re-blended at
# full range; frames beyond either take the full fallback.
PATCH_TILES = 16
PATCH_WMAX = 16384


# Frames per branch of `capped_finish`: every tile valid (fast), the patch
# pass, or the full blend.  Host-side counts, read by chip_smoke.py.
PATH_COUNTS = {"fast": 0, "patch": 0, "full": 0}


class CapsState(NamedTuple):
    """Temporal per-tile state carried across frames ([T] int64 each).

    caps:  blend truncation caps.
    thr:   depth-key prefilter thresholds (ops/prefilter.py); SENTINEL
           leaves the tile unfiltered.
    floor: smallest trusted cap (the saturation-decay ratchet).
    """

    caps: torch.Tensor
    thr: torch.Tensor
    floor: torch.Tensor


class CappedLayout(NamedTuple):
    """The packed layout of one frame (`capped_layout`).

    gid:      [ep] int64 gaussian id per packed slot, SENTINEL where dead.
    pstart:   [T] int64 packed start of each tile's live run.
    counts:   [T] int64 elements blended per tile (cap- and crossing-cut).
    r:        [T] int64 full range length per tile.
    fits:     [] bool, the layout fits ep slots.
    pcum_end: [] int64 slots the layout needs.
    filtered: [T] bool tiles under a threshold (None without CapsState).
    """

    gid: torch.Tensor
    pstart: torch.Tensor
    counts: torch.Tensor
    r: torch.Tensor
    fits: torch.Tensor
    pcum_end: torch.Tensor
    filtered: torch.Tensor | None


def _f32(x: float) -> float:
    """A threshold as the JAX package forms it: jnp.float32(x)."""
    return float(np.float32(x))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def init_caps(config: RenderConfig, device=None) -> torch.Tensor:
    """Initial per-tile caps for the temporal policy (no prefilter)."""
    assert config.blend_depth_cap > 0
    return torch.full((config.num_tiles,), config.blend_depth_cap, dtype=torch.int64,
                      device=device)


def init_caps_state(config: RenderConfig, device=None) -> CapsState:
    """Initial CapsState: base caps, every tile unfiltered, base floors."""
    return CapsState(
        caps=init_caps(config, device),
        thr=torch.full((config.num_tiles,), SENTINEL, dtype=torch.int64, device=device),
        floor=init_caps(config, device),
    )


def packed_capacity(config: RenderConfig, capacity: int) -> int:
    """Packed-layout capacity of the static-cap path (rounded to 512)."""
    cap_p = _round_up(config.blend_depth_cap, SEG_ALIGN) + SEG_ALIGN
    bound_a = config.num_tiles * cap_p
    bound_b = _round_up(capacity, SEG_ALIGN) + 2 * SEG_ALIGN * config.num_tiles
    return _round_up(min(bound_a, bound_b), 512)


def packed_capacity_temporal(config: RenderConfig, capacity: int) -> int:
    """Packed-layout capacity of the temporal path: the static cap's bound
    plus `packed_slack_per_tile` slots per tile (rounded to 512)."""
    cap_p = _round_up(config.blend_depth_cap, SEG_ALIGN) + SEG_ALIGN
    bound_a = config.num_tiles * (cap_p + config.packed_slack_per_tile)
    bound_b = _round_up(capacity, SEG_ALIGN) + 2 * SEG_ALIGN * config.num_tiles
    return _round_up(min(bound_a, bound_b), 512)


def _crossing_counts(elements: SortElements, starts, r, caps, thr):
    """Per-tile blend counts under caps and depth thresholds: a filtered
    tile (thr != SENTINEL) is also cut at its threshold crossing, the first
    in-range element with depth > thr."""
    filtered = thr != SENTINEL
    counts_plain = torch.minimum(r, caps)
    tids = torch.arange(starts.shape[0], device=starts.device)
    # Probe (t, thr + 1); thr is clamped below SENTINEL so the +1 stays a
    # uint32 in the JAX package (ops/search.py).
    probe_lo = torch.clamp(thr, max=SENTINEL - 1) + 1
    pcross = two_level_lex_search(elements.tile, elements.depth, tids, probe_lo)
    pfx = torch.minimum(torch.clamp(pcross - starts, min=0), r)
    return torch.where(filtered, torch.minimum(counts_plain, pfx), counts_plain), filtered


def _tile_validity(t_max, r, counts, filtered, config: RenderConfig):
    """Range fit OR saturation at the (trimmed) end; filtered tiles only by
    saturation."""
    sat = t_max < _f32(config.transmittance_stop * config.cap_validation_factor)
    valid = (r <= counts) | sat
    if filtered is not None:
        valid = torch.where(filtered, sat, valid)
    return valid


def _count_unfixable(valid, thr):
    """Invalid tiles that were prefiltered (the patch pass cannot recover
    their dropped tail)."""
    return (~valid & (thr != SENTINEL)).sum()


def _layout(elements, ranges, config, caps, thr, ep):
    starts = ranges[:, 0]
    # FindRanges' quirk at a full list can leave end < start (ops/ranges.py);
    # JAX carries the negative length into the slab sums, the port treats
    # the tile as empty (see the module docstring).
    r = torch.clamp(ranges[:, 1] - starts, min=0)
    if thr is None:
        counts, filtered = torch.minimum(r, caps), None
    else:
        counts, filtered = _crossing_counts(elements, starts, r, caps, thr)
    # Alignment-preserving slabs: tile t's run lands at sbase_t + off_t.
    off = torch.remainder(starts, SEG_ALIGN)
    slabw = torch.div(off + counts + SEG_ALIGN - 1, SEG_ALIGN, rounding_mode="floor") * SEG_ALIGN
    pcum = torch.cumsum(slabw, 0)
    sbase = pcum - slabw
    return CappedLayout(
        gid=compact_kernel.compact_slabs(elements.index, starts, sbase, slabw, off, counts, ep),
        pstart=sbase + off,
        counts=counts,
        r=r,
        fits=pcum[-1] <= ep,
        pcum_end=pcum[-1],
        filtered=filtered,
    )


def _split_caps(caps, config: RenderConfig):
    """(caps clipped to [base, cap_max], thr or None, floor or None)."""
    is_state = isinstance(caps, CapsState)
    c = caps.caps if is_state else caps
    c = torch.clamp(c.to(torch.int64), config.blend_depth_cap, config.blend_cap_max)
    return c, (caps.thr if is_state else None), (caps.floor if is_state else None)


def capped_layout(elements, ranges, frame, config: RenderConfig, caps):
    """Phase 1: the packed layout and id compaction of a frame (K5).

    caps: [T] int64 caps or a CapsState (enables threshold trimming).
    `frame` (JAX's signature) is not read: K3 reads the frame data itself
    in `capped_finish`."""
    capacity = elements.tile.shape[0]
    ep = packed_capacity_temporal(config, capacity)
    c, thr, _floor = _split_caps(caps, config)
    return _layout(elements, ranges, config, c, thr, ep)


def blend_tiles_capped(elements, ranges, frame, config: RenderConfig, *, timer=None):
    """Static-cap capped blend, exact or the full blend; [H, W, 3].

    Static caps carry no hysteresis, so validation is at the plain stop.
    `timer` records the branch's read-back as a `sync` span."""
    cap = config.blend_depth_cap
    assert 0 < cap <= config.blend_cap_max
    blend = blend_ops.blend_flat
    ep = packed_capacity(config, elements.tile.shape[0])
    caps = torch.full((config.num_tiles,), cap, dtype=torch.int64, device=ranges.device)
    lay = _layout(elements, ranges, config, caps, None, ep)
    pranges = torch.stack([lay.pstart, lay.pstart + lay.counts], dim=1)
    img, t_out = blend(frame, lay.gid, pranges, config, with_t=True)
    valid = (lay.r <= caps) | (t_out.amax(dim=1) < _f32(config.transmittance_stop))
    if not read_back(timer, valid.all() & lay.fits):  # the frame's host sync
        img = blend(frame, elements.index, ranges, config)
    return img


def _policy_update(config: RenderConfig, ep: int, caps, thr, floor, r, counts, starts,
                   depth_col, t_max, valid, fits, pcum_end):
    """Next-frame caps, thresholds and floors from this frame's validation
    (JAX capped.py:331-454, rule for rule)."""
    base = config.blend_depth_cap
    cap_max = config.blend_cap_max
    margin_ok = t_max < _f32(config.transmittance_stop * config.cap_escalate_margin)
    esc = torch.clamp(caps * 2, max=cap_max)
    dec = torch.clamp(torch.div(caps, 2, rounding_mode="floor"), min=base)
    stay = (r <= caps) | margin_ok
    n_grow = (valid & ~stay).sum()
    room = pcum_end + n_grow * 128 <= int(ep * 0.97)
    grow = torch.where(room, torch.clamp(caps + 128, max=cap_max), caps)
    if floor is not None and config.cap_decay_margin > 0:
        deep = (
            t_max
            < _f32(config.transmittance_stop * config.cap_escalate_margin * config.cap_decay_margin)
        ) & (counts < r)
        hold = torch.where(deep, torch.maximum(caps - 128, torch.clamp(floor, min=base)), caps)
    else:
        hold = caps
    caps_next = torch.where(
        valid, torch.where(stay, torch.where(r * 2 <= caps, dec, hold), grow), esc
    )
    shed = torch.clamp(caps - 128, min=base)
    caps_next = torch.where(fits, caps_next, shed)

    if floor is not None:
        floor_next = torch.where(~valid, esc, floor)
        floor_next = torch.where(valid & (r * 2 <= caps), base, floor_next)
    else:
        floor_next = None

    if thr is None:
        return caps_next, None, floor_next, n_grow
    e = depth_col.shape[0]
    publish = valid & (t_max < _f32(config.transmittance_stop * config.thr_publish_margin)) & fits
    depth_end = depth_col[torch.clamp(starts + counts - 1, 0, e - 1)]
    if config.thr_reset_damp:
        high = thr >= SENTINEL // 2
        dbl = torch.clamp(torch.where(high, SENTINEL, thr * 2), min=SENTINEL // 64)
        reset = torch.where(high, SENTINEL, dbl)
    else:
        reset = torch.full_like(thr, SENTINEL)
    thr_next = torch.where(publish, torch.clamp(depth_end, max=SENTINEL - 1), reset)
    return caps_next, thr_next, floor_next, n_grow


def _patch_pass(img, valid, elements, ranges, frame, config: RenderConfig):
    """Re-blend the (<= PATCH_TILES) invalid tiles at full range and merge
    them into `img`.  The caller has checked the budgets."""
    t = config.num_tiles
    k = min(PATCH_TILES, t)
    ep_patch = k * PATCH_WMAX
    device = ranges.device

    score = torch.where(valid, -1, torch.arange(t, device=device))
    tvals = torch.topk(score, k, sorted=True).values  # invalid tile ids, then -1
    is_real = tvals >= 0
    t_idx = torch.clamp(tvals, min=0)
    starts_p = torch.where(is_real, ranges[t_idx, 0], 0)
    r_p = torch.clamp(torch.where(is_real, ranges[t_idx, 1], 0) - starts_p, min=0)
    off = torch.remainder(starts_p, SEG_ALIGN)
    slabw = torch.div(off + r_p + SEG_ALIGN - 1, SEG_ALIGN, rounding_mode="floor") * SEG_ALIGN
    pcum = torch.cumsum(slabw, 0)
    sbase = pcum - slabw

    gid = compact_kernel.compact_slabs(elements.index, starts_p, sbase, slabw, off, r_p, ep_patch)

    # Tile -> patch slab (JAX: a [T, PATCH_TILES] one-hot matmul).
    slot = torch.where(is_real, tvals, t)
    pstart_t = torch.zeros(t + 1, dtype=torch.int64, device=device).scatter_add_(
        0, slot, sbase + off)[:t]
    count_t = torch.zeros(t + 1, dtype=torch.int64, device=device).scatter_add_(
        0, slot, r_p)[:t]
    pranges = torch.stack([pstart_t, pstart_t + count_t], dim=1)
    img_p = blend_ops.blend_flat(frame, gid, pranges, config)

    gh, gw, ts = config.grid_height, config.grid_width, config.tile_size
    vmask = valid.reshape(gh, 1, gw, 1).expand(gh, ts, gw, ts).reshape(gh * ts, gw * ts)
    vmask = vmask[: config.height, : config.width]
    return torch.where(vmask[:, :, None], img, img_p)


def capped_finish(lay: CappedLayout, caps, elements, ranges, frame, config: RenderConfig,
                  ep: int, *, timer=None):
    """Phases 2-3: blend (K3 with T), validation, the caps/threshold update
    and the patch pass or full fallback.

    Returns (img [H, W, 3], caps_next (the kind of `caps`), ok [] bool,
    stats [5] int64 = (n_invalid, fits, packed_end, n_grow, n_unfix))."""
    blend = blend_ops.blend_flat
    c, thr, floor = _split_caps(caps, config)
    with section(timer, "blend"):
        pranges = torch.stack([lay.pstart, lay.pstart + lay.counts], dim=1)
        img, t_out = blend(frame, lay.gid, pranges, config, with_t=True)
    with section(timer, "policy"):
        t_max = t_out.amax(dim=1)
        r, fits = lay.r, lay.fits
        valid = _tile_validity(t_max, r, lay.counts, lay.filtered, config)
        ok = valid.all() & fits
        caps_next, thr_next, floor_next, n_grow = _policy_update(
            config, ep, c, thr, floor, r, lay.counts, ranges[:, 0], elements.depth,
            t_max, valid, fits, lay.pcum_end,
        )
        n_invalid = (~valid).sum()
        patchable = (
            fits
            & (n_invalid <= PATCH_TILES)
            & torch.where(valid, True, r <= PATCH_WMAX - SEG_ALIGN).all()
        )
        # The frame's one deliberate host synchronisation: the branch below.
        fast, patch = read_back(timer, torch.stack([ok, patchable]))
    PATH_COUNTS["fast" if fast else "patch" if patch else "full"] += 1
    with section(timer, "patch"):
        if not fast:
            if patch:
                img = _patch_pass(img, valid, elements, ranges, frame, config)
            else:
                img = blend(frame, elements.index, ranges, config)
    ok = ok | patchable
    if thr is not None:
        n_unfix = _count_unfixable(valid, thr)
        ok = ok & (n_unfix == 0)
        caps_out = CapsState(caps=caps_next, thr=thr_next, floor=floor_next)
    else:
        n_unfix = torch.zeros((), dtype=torch.int64, device=ranges.device)
        caps_out = caps_next
    stats = torch.stack([n_invalid, fits.to(torch.int64), lay.pcum_end, n_grow, n_unfix])
    return img, caps_out, ok, stats


def blend_tiles_capped_split(elements, ranges, frame, config: RenderConfig, caps, *,
                             timer=None):
    """One temporal capped frame: `capped_layout` then `capped_finish`.
    Returns (img, caps_next, ok, stats)."""
    ep = packed_capacity_temporal(config, elements.tile.shape[0])
    with section(timer, "layout"):
        lay = capped_layout(elements, ranges, frame, config, caps)
    return capped_finish(lay, caps, elements, ranges, frame, config, ep, timer=timer)


def blend_tiles_capped_temporal(elements: SortElements, ranges, frame: GaussianFrameData,
                                config: RenderConfig, caps, *, timer=None):
    """Per-tile temporal-caps blend.  `caps` is the previous frame's state:
    a [T] caps tensor (init_caps) or a CapsState (init_caps_state, which
    also publishes prefilter thresholds); caps_next mirrors its kind.

    Returns (image [H, W, 3], caps_next, ok [] bool)."""
    assert config.blend_depth_cap > 0
    img, caps_next, ok, _stats = blend_tiles_capped_split(
        elements, ranges, frame, config, caps, timer=timer
    )
    return img, caps_next, ok
