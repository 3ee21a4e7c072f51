"""Sort-element ordering — port of `vk3dgaussiansplatting_tpu.ops.sort`.

The reference sorts {tileKey, depthKey, gaussianIdx} by the 64-bit key
(tileKey << 32) | depthKey with a 4-bit LSD radix sort (RadixSort.cpp).
Here one stable `torch.sort` on that int64 key stands in for it, as
`lax.sort` does in the JAX package (neither side is a hand-written kernel).

Stability gives JAX's 3-key (tile, depth, index) order: within one
(tile, depth) pair the gaussian ids are distinct and ascend with slot order,
because keygen emits gaussians in index order.  Sentinel slots are all-equal.

The SENTINEL tile 0xFFFFFFFF shifted by 32 would overflow int64, so it is
first mapped to `num_tiles` (above every live tile, as the JAX sort maps it
to 0xFFFF) and mapped back after the sort.

`SortAlgorithm.BITONIC` selects the reference's other sort, the bitonic
merge network (ops/bitonic.py, a CUDA kernel on the card), which gives the
same order at a power-of-two capacity.
"""

from __future__ import annotations

import torch

from ..core.config import SENTINEL, RenderConfig, SortAlgorithm
from . import bitonic
from .keygen import SortElements


def sort_elements_xla(elements: SortElements, num_tiles: int) -> SortElements:
    """Order the elements by (tile, depth), stably."""
    if not 0 < num_tiles < 2**31:
        raise ValueError(f"num_tiles {num_tiles} does not fit the int64 key")
    tile = torch.where(elements.tile == SENTINEL, num_tiles, elements.tile)
    key, perm = torch.sort((tile << 32) | elements.depth, stable=True)
    tile = key >> 32
    return SortElements(
        tile=torch.where(tile == num_tiles, SENTINEL, tile),
        depth=key & 0xFFFFFFFF,
        index=elements.index[perm],
        count=elements.count,
    )


def sort_elements(elements: SortElements, config: RenderConfig) -> SortElements:
    """Dispatch on the configured sort algorithm."""
    algo = config.sort_algorithm
    if algo in (SortAlgorithm.AUTO, SortAlgorithm.XLA_SORT):
        return sort_elements_xla(elements, config.num_tiles)
    if algo == SortAlgorithm.BITONIC:
        return bitonic.sort_elements_bitonic(elements)
    raise ValueError(f"unknown sort algorithm {algo}")
