"""Distributed frame: the depth-banded render over `torch.distributed` ranks.

Port of `vk3dgaussiansplatting_tpu.parallel.dist` (whose docstring has the
design).  JAX runs the frame as one `shard_map` program over a device mesh;
here every rank runs `make_distributed_render`'s frame function in its own
process, and the collectives go through parallel/mesh.py's `Communicator`.
One frame, per rank:

  1. keygen on the rank's table shard at `DistConfig.local_capacity`; ids
     made global (+ rank * shard size);
  2. depth bands: thresholds from an all-gathered strided depth sample;
     destination (tile // tiles_per_rank + band) % world, dead slots to
     `world`; bucketed into [world, slab] slots (stable sort by destination,
     run starts, one gather; a run's tail past the slab drops);
  3. one all_to_all of int32 words, 12 a slot (JAX's 48 B): tile, depth,
     global id and, with `route_features` (the default), the element's 9
     blend features as float32 bits, so no rank needs the whole table;
  4. the (tile, depth, id) sort, `find_ranges` on global tile ids, and the
     per-strip windows of `strip_capacity` slots (`dropped` counts tails past
     them);
  5. the systolic blend: in phase s rank d blends strip (d - s) % world with
     K4 (ops/blend.py:blend_strip) from the (colour, log T)
     carry, then sends the result to rank d + 1; after the last phase rank d
     holds strip d.

Outputs: (strip [strip_h, W, 3], dropped [1]), or with `return_stats`
(strip, [1, 4] = [live_local, sent_live, recv_live, dropped]), the JAX
function's per-device shapes.  JAX's `use_pallas_blend` has no counterpart:
the tensors' device picks K4 (CUDA) or its plain version (CPU), and JAX's
log-space `blend_strip_colors_xla` tier has no twin, K4's plain version
(ops/blend.py:blend_strip_plain) takes its place.

Integer keys are int64 tensors holding JAX's uint32 values (SENTINEL
included) up to the exchange, which carries their 32-bit patterns as int32.
The frame reads back one small tensor per frame: the strip windows' starts,
to slice them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.config import SENTINEL, RenderConfig
from ..models.gaussians import GaussianTable
from ..ops import blend as blend_ops
from ..ops import keygen as keygen_ops
from ..ops import ranges as ranges_ops
from ..ops import sort as sort_ops
from ..utils.timing import read_back, section

_DEPTH_SAMPLE = 512  # per-rank depth-quantile sample size
# Exchange words per slot: tile, depth, global id, then the 9 feature words
# (gx, gy, a', b', c', r, g, b, galpha: pack_feature_table's columns without
# its zero column).
_KEY_WORDS = 3
_FEATURE_WORDS = 9


def _pad_table(table: GaussianTable, multiple: int) -> GaussianTable:
    """Pad the table so its length divides by `multiple`; the padding
    gaussians have zero opacity and zero scale, so they cull to zero tiles."""
    pad = (-table.num_gaussians) % multiple
    if pad == 0:
        return table

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=table.device)

    rot = zeros(pad, 4)
    rot[:, 0] = 1.0
    return GaussianTable(
        position=torch.cat([table.position, zeros(pad, 3)]),
        scale=torch.cat([table.scale, zeros(pad, 3)]),
        rot=torch.cat([table.rot, rot]),
        sh=torch.cat([table.sh, zeros(pad, *table.sh.shape[1:])]),
        opacity=torch.cat([table.opacity, zeros(pad)]),
    )


def shard_table(table: GaussianTable, rank: int, world: int) -> GaussianTable:
    """Rank `rank`'s contiguous 1/world of a padded table (JAX's
    `P(SHARD_AXIS)` layout)."""
    n = table.num_gaussians
    if n % world:
        raise ValueError(f"{n} gaussians do not split over {world} ranks (pad with _pad_table)")
    m = n // world
    return GaussianTable(*(
        getattr(table, f.name)[rank * m : (rank + 1) * m]
        for f in dataclasses.fields(GaussianTable)
    ))


class DistConfig(NamedTuple):
    """Static distributed-layout parameters (the JAX DistConfig's fields)."""

    num_devices: int
    tile_rows_per_device: int  # grid_height rows per rank (image strip)
    local_capacity: int  # keygen capacity per rank
    slab_capacity: int  # per-peer exchange capacity
    strip_capacity: int  # per-phase strip element window


def plan_distribution(
    config: RenderConfig,
    num_gaussians: int,
    num_devices: int,
    slab_slack: float = 2.0,
) -> DistConfig:
    """The JAX package's plan (parallel/dist.py:109-144), integer for
    integer: the full per-tile slack per shard, slabs of
    2 * local_capacity / world, strip windows of twice a slab again."""
    if config.grid_height % num_devices != 0:
        raise ValueError(
            f"grid_height={config.grid_height} must divide evenly over "
            f"{num_devices} devices (pad the image height)"
        )
    n_local = -(-num_gaussians // num_devices)
    local_capacity = config.sort_capacity(n_local)
    slab_capacity = int(-(-local_capacity // num_devices) * slab_slack)
    strip_capacity = min(num_devices * slab_capacity, int(slab_capacity * 2 * slab_slack))
    return DistConfig(
        num_devices=num_devices,
        tile_rows_per_device=config.grid_height // num_devices,
        local_capacity=local_capacity,
        slab_capacity=slab_capacity,
        strip_capacity=strip_capacity,
    )


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> their int32 bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _from_i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def _depth_band_thresholds(depth: torch.Tensor, comm, timer=None) -> torch.Tensor:
    """Rank-uniform depth-quantile thresholds [world - 1] (int64, ascending)
    from an all-gathered strided sample of every rank's depth keys; SENTINEL
    (dead) keys sort to the tail and are left out by the live count."""
    ndev = comm.world
    with section(timer, "bucket"):
        stride = max(1, depth.shape[0] // _DEPTH_SAMPLE)
        sample = depth[::stride].contiguous()
    with section(timer, "exchange"):
        all_s = comm.all_gather(sample)
    with section(timer, "bucket"):
        all_s = torch.sort(all_s).values
        live_n = (all_s != SENTINEL).sum()
        k = torch.arange(1, ndev, device=depth.device)
        ranks = torch.clamp(torch.div(live_n * k, ndev, rounding_mode="floor"), 0, all_s.shape[0] - 1)
        return all_s[ranks]


def _bucket_by_destination(words: torch.Tensor, dest: torch.Tensor, ndev: int, slab: int) -> torch.Tensor:
    """Pack element rows `words` [E, C] int32 into [ndev, slab, C] slots
    grouped by destination `dest` [E] (int64; `ndev` is dead), in input order
    within each slab; empty slots are all -1 (SENTINEL's bits).  A run longer
    than `slab` drops its tail (the reference's sort-list overflow rule,
    InitSortList.comp:143)."""
    dest_s, perm = torch.sort(dest, stable=True)
    starts = torch.searchsorted(dest_s, torch.arange(ndev + 1, device=dest.device))
    slot = torch.arange(ndev * slab, device=dest.device)
    d_of = torch.div(slot, slab, rounding_mode="floor")
    src = starts[d_of] + slot - d_of * slab
    in_run = src < starts[d_of + 1]
    out = words[perm[torch.where(in_run, src, 0)]]
    out = torch.where(in_run[:, None], out, -1)
    return out.reshape(ndev, slab, words.shape[1])


def _sort3(tile: torch.Tensor, depth: torch.Tensor, index: torch.Tensor, num_tiles: int):
    """The (tile, depth, gaussian id) order of JAX's 3-key sort, as the AUTO
    sort's stable radix sort on (tile, depth) (ops/sort.py; the kernel
    csrc/radix.cu on the card) over every slot: a received list holds
    sentinels between its live slots, so no count bounds it.  The id order
    needs no key: in a received list, slots of one (tile, depth) come from
    source ranks in rank order (all_to_all) and, within a rank, in keygen's
    slot order (stable bucketing), so their global ids (rank * shard +
    local id) ascend already.  Returns (tile, depth, index) sorted and the
    permutation."""
    el, perm = sort_ops.sort_elements_xla(keygen_ops.SortElements(tile, depth, index, None),
                                          num_tiles, with_perm=True)
    return el.tile, el.depth, el.index, perm


def make_distributed_render(
    comm,
    config: RenderConfig,
    dist: DistConfig,
    *,
    return_stats: bool = False,
    route_features: bool = True,
):
    """Build this rank's frame function
    `frame(table_shard, view, proj, cam_pos, timer=None)` ->
    (strip, dropped) or, with `return_stats`, (strip, stats).

    strip: [tile_rows_per_device * 16, W, 3] float32 in [0, 1], this rank's
    image rows.  dropped: [1] int64, elements the strip windows truncated;
    it MUST be 0 for the image to be exact (as in JAX; slab-overflow drops
    show in the stats).  stats: [1, 4] int64
    [live_local, sent_live, recv_live, dropped].  table_shard: this rank's
    `shard_table` of a `_pad_table`-padded table, on `comm.device`.  `timer`
    (utils.timing.CudaPassTimer) records the `frame` span and under it
    keygen (expand inside), bucket, exchange, sort, ranges (with the strip
    windows' read-back, a `sync`) and blend; with gloo on a GPU, exchange
    includes the copies through host memory."""
    ndev = dist.num_devices
    if comm.world != ndev:
        raise ValueError(f"the plan is for {ndev} ranks, the group has {comm.world}")
    if config.grid_height != dist.tile_rows_per_device * ndev:
        raise ValueError(
            f"grid_height={config.grid_height} != {ndev} ranks x "
            f"{dist.tile_rows_per_device} tile rows"
        )
    tiles_per_dev = dist.tile_rows_per_device * config.grid_width
    strip_config = dataclasses.replace(config, height=dist.tile_rows_per_device * config.tile_size)
    p = config.tile_size * config.tile_size
    n_words = _KEY_WORDS + (_FEATURE_WORDS if route_features else 0)

    def frame(table, view, proj, cam_pos, timer=None):
        with section(timer, "frame"):
            return _frame(table, view, proj, cam_pos, timer)

    def _frame(table, view, proj, cam_pos, timer):
        dev = comm.device
        with section(timer, "keygen"):
            elements, frame_data = keygen_ops.generate_sort_elements(
                table, view, proj, cam_pos, config, dist.local_capacity, timer=timer
            )
        live = elements.index != SENTINEL

        thr = _depth_band_thresholds(elements.depth, comm, timer)
        with section(timer, "bucket"):
            table_rows = blend_ops.pack_feature_table(frame_data)
            band = torch.searchsorted(thr, elements.depth, right=True)
            owner = torch.div(elements.tile, tiles_per_dev, rounding_mode="floor")
            dest = torch.where(live, (owner + band) % ndev, ndev)
            words = torch.empty((elements.tile.shape[0], n_words), dtype=torch.int32, device=dev)
            words[:, 0] = _to_i32(elements.tile)
            words[:, 1] = _to_i32(elements.depth)
            gid = torch.where(live, elements.index + comm.rank * table.num_gaussians, SENTINEL)
            words[:, 2] = _to_i32(gid)
            if route_features:
                rows = table_rows[torch.where(live, elements.index, 0)]
                words[:, 3:8] = rows[:, :5].view(torch.int32)
                words[:, 8:] = rows[:, 6:].view(torch.int32)
            slabs = _bucket_by_destination(words, dest, ndev, dist.slab_capacity)
            if return_stats:
                live_local = live.sum()
                sent_live = (slabs[:, :, 0] != -1).sum()

        with section(timer, "exchange"):
            recv = comm.all_to_all(slabs.reshape(ndev * dist.slab_capacity, n_words))
            if not route_features:
                table_rows = comm.all_gather(table_rows)  # every rank's gaussians

        with section(timer, "sort"):
            st, sd, si, perm = _sort3(
                _from_i32(recv[:, 0]), _from_i32(recv[:, 1]), _from_i32(recv[:, 2]),
                config.num_tiles,
            )
            live_r = st != SENTINEL
            count = live_r.sum()
            if route_features:
                # Dead slots carry -1 words, NaN as float32: zero them.
                f = torch.where(live_r[:, None], recv[:, _KEY_WORDS:][perm].view(torch.float32), 0.0)
                table_rows = torch.cat([f[:, :5], torch.zeros_like(f[:, :1]), f[:, 5:]], dim=1)

        with section(timer, "ranges"):
            ranges = ranges_ops.find_ranges(keygen_ops.SortElements(st, sd, si, count), config.num_tiles)
            # Strip windows: the list is tile-sorted, so strip g's elements
            # are one run, cut to strip_capacity slots.
            e_recv = st.shape[0]
            strip_cap = min(dist.strip_capacity, e_recv)
            probes = torch.arange(ndev + 1, device=dev) * tiles_per_dev
            bounds = torch.searchsorted(st, probes)
            s0_all = torch.clamp(bounds[:-1], max=e_recv - strip_cap)
            dropped = torch.clamp(bounds[1:] - s0_all - strip_cap, min=0).sum()
            s0_host = read_back(timer, s0_all)

        colors = torch.zeros((tiles_per_dev, p, 3), device=dev)
        logt = torch.zeros((tiles_per_dev, p), device=dev)
        for s in range(ndev):
            g = (comm.rank - s) % ndev
            tile_base = g * tiles_per_dev
            s0 = s0_host[g]
            with section(timer, "blend"):
                rng_s = torch.clamp(ranges[tile_base : tile_base + tiles_per_dev] - s0, 0, strip_cap)
                colors, logt = blend_ops.blend_strip(
                    table_rows[s0 : s0 + strip_cap] if route_features else table_rows,
                    si[s0 : s0 + strip_cap],
                    rng_s,
                    config,
                    tile_base=tile_base,
                    carry_color=colors,
                    carry_logt=logt,
                    gather=not route_features,
                )
            with section(timer, "exchange"):
                carry = comm.ring_shift(torch.cat([colors, logt[..., None]], dim=-1))
            colors, logt = carry[..., :3].contiguous(), carry[..., 3].contiguous()

        strip = blend_ops.assemble_tile_colors(colors, strip_config)
        if return_stats:
            return strip, torch.stack([live_local, sent_live, count, dropped]).reshape(1, 4)
        return strip, dropped.reshape(1)

    return frame
