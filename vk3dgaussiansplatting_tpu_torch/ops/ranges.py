"""Per-tile range extraction — the FindRanges pass.

Port of `vk3dgaussiansplatting_tpu.ops.ranges`: each tile's [start, end) is
found by binary search of the sorted tile keys (ops/search.py, one
`torch.searchsorted`) instead of the reference's per-element boundary
scatter (FindRanges.comp).

Quirks reproduced from FindRanges.comp:44-70, as in the JAX package:
  * tiles with no elements report (0, 0), the reference's cleared buffer;
  * the final slot only ever writes `end = E-1`: when slot E-1 is live its
    tile's end is clamped to E-1 (dropping that element), and when the
    E-2/E-1 boundary is a real tile change neither `end[tile[E-2]]` nor
    `start[tile[E-1]]` is written (they stay 0).
"""

from __future__ import annotations

import torch

from ..core.config import SENTINEL
from .keygen import SortElements
from .search import two_level_left_search


def find_ranges(elements: SortElements, num_tiles: int) -> torch.Tensor:
    """[num_tiles, 2] int64 (start, end) ranges from sorted tiles."""
    tile = elements.tile
    e = tile.shape[0]
    # searchsorted(t, "right") == searchsorted(t + 1, "left") on integer
    # keys: probing 0..num_tiles once gives starts and ends.
    probes = torch.arange(num_tiles + 1, device=tile.device, dtype=tile.dtype)
    ext = two_level_left_search(tile, probes)
    starts, ends = ext[:-1], ext[1:]
    empty = starts == ends
    starts = torch.where(empty, 0, starts)
    ends = torch.where(empty, 0, ends)

    if e >= 2:
        tids = probes[:-1]
        last = tile[e - 1]
        prev = tile[e - 2]
        last_live = last != SENTINEL
        ends = torch.where(last_live & (tids == last), e - 1, ends)
        boundary = last_live & (prev != last)
        ends = torch.where(boundary & (tids == prev) & (prev != SENTINEL), 0, ends)
        starts = torch.where(boundary & (tids == last), 0, starts)

    return torch.stack([starts, ends], dim=-1)
