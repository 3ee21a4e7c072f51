"""Sort-element ordering — port of `vk3dgaussiansplatting_tpu.ops.sort`.

The reference sorts {tileKey, depthKey, gaussianIdx} by the 64-bit key
(tileKey << 32) | depthKey with an LSD radix sort over the used key bits
(RadixSort.cpp), bounded by the GPU-side live count.  The JAX package runs
`lax.sort` on three keys there (a radix sort cost too much on the TPU,
its ops/sort.py docstring says); the port runs the reference's shape:
`sort_elements_xla` is an LSD radix sort of 8-bit digits, the CUDA kernel
csrc/radix.cu (ops/cuda/radix_kernel.py) on CUDA tensors and
`sort_elements_radix_plain`, the kernel's arithmetic in torch ops, on CPU
tensors.  Neither falls back to the other.  The kernel is one-sweep: one
histogram kernel counts every digit in one read of the key columns, then
one scatter kernel a digit finds each partition's place in its bins by
decoupled look-back over the earlier partitions; the plain version sums
the same counts directly (`_counting_pass`), so the two give the same
destinations.

The key is tile' above the 32 depth bits, where tile' maps the SENTINEL
tile 0xFFFFFFFF to `num_tiles` (above every live tile, as the JAX sort maps
it to 0xFFFF): 32 + bit_length(num_tiles) bits, 8 a pass
(`radix_kernel.schedule`).  Every pass is stable, so ties keep slot order:
within one (tile, depth) pair keygen's gaussian ids ascend with slot order,
so that is JAX's 3-key (tile, depth, index) order.  Sentinel slots are
all-equal.

`count` bounds the sorted prefix: slots at and past it are written as
SENTINEL triples, as keygen's lists hold there; where an input slot there is
not a SENTINEL triple, every slot is sorted, so the result is always the
stable sort of the whole list.

`SortAlgorithm.BITONIC` selects the reference's other sort, the bitonic
merge network (ops/bitonic.py, a CUDA kernel on the card), which gives the
same order at a power-of-two capacity.
"""

from __future__ import annotations

import torch

from ..core.config import SENTINEL, RenderConfig, SortAlgorithm
from . import bitonic
from .cuda import radix_kernel
from .keygen import SortElements

# Rounds whose lanes the plain version compares in one step ([rounds, 32, 32]).
_PLAIN_ROUNDS = 1 << 15
_LANES = 32


def _sorted_len(elements: SortElements) -> int:
    """The sorted prefix: min(count, E), or E without a count or when a slot
    past the count is not a SENTINEL triple (csrc/radix.cu's setup)."""
    e = elements.tile.shape[0]
    if elements.count is None:
        return e
    n = min(max(int(elements.count), 0), e)
    tail = [x[n:] for x in elements[:3]]
    return n if all(bool((x == SENTINEL).all()) for x in tail) else e


def _counting_pass(digit: torch.Tensor) -> torch.Tensor:
    """One stable counting pass over 8-bit digits, counted as the kernel's
    scatter counts it: slot i of partition b (TILE slots) is lane i % 32 of
    round i // 32 % ITEMS of warp i % TILE // (32 * ITEMS); its destination
    is its bin's base (the scanned global histogram) + the earlier
    partitions' count of the bin (what the kernel's look-back sums) + the
    partition's earlier warps' count + the warp's earlier rounds' count +
    the round's lower lanes with its digit.  Returns each slot's
    destination."""
    n = digit.shape[0]
    dev = digit.device
    bins, tile = radix_kernel.BINS, radix_kernel.TILE
    nparts = -(-n // tile)
    # Pad to whole partitions; a pad slot has digit BINS, no bin.
    d = torch.cat([digit, digit.new_full((nparts * tile - n,), bins)])
    lanes = d.view(-1, _LANES)
    lower = torch.ones(_LANES, _LANES, dtype=torch.bool, device=dev).tril(-1)
    below = torch.cat([((r[:, :, None] == r[:, None, :]) & lower).sum(2)
                       for r in lanes.split(_PLAIN_ROUNDS)]).view(-1)
    nrounds = lanes.shape[0]
    rnd = torch.arange(nrounds, device=dev).repeat_interleave(_LANES)
    hist = torch.bincount(rnd * (bins + 1) + d, minlength=nrounds * (bins + 1))
    per_warp = hist.view(-1, radix_kernel.ITEMS, bins + 1)[..., :bins]
    round_before = (per_warp.cumsum(1) - per_warp).reshape(nrounds, bins)
    per_part = per_warp.sum(1).view(nparts, radix_kernel.WARPS, bins)
    warp_before = (per_part.cumsum(1) - per_part).reshape(-1, bins)
    table = per_part.sum(1).T  # [bins, nparts]: each partition's count of each bin
    before = table.cumsum(1) - table
    totals = table.sum(1)
    base = totals.cumsum(0) - totals
    slot = torch.arange(n, device=dev)
    warp = slot // (_LANES * radix_kernel.ITEMS)
    return (base[digit] + before[digit, slot // tile] + warp_before[warp, digit]
            + round_before[slot // _LANES, digit] + below[:n])


def sort_elements_radix_plain(elements: SortElements, num_tiles: int, *,
                              with_perm: bool = False):
    """csrc/radix.cu in torch ops: the key map, the count bound and the
    sentinel fill, then one stable counting pass a digit of
    `radix_kernel.schedule(num_tiles)`.  `elements.count` None sorts every
    slot.  Returns the sorted SortElements and, with `with_perm`, the [E]
    int64 slot permutation."""
    e = elements.tile.shape[0]
    dev = elements.tile.device
    n = _sorted_len(elements)
    t = elements.tile[:n]
    slot = torch.arange(e, device=dev)
    # The records: depth, tile' and the payload (the slot, or the id).
    rec = {"depth": elements.depth[:n], "tile": torch.where(t == SENTINEL, num_tiles, t),
           "pay": slot[:n] if with_perm else elements.index[:n]}
    for column, shift, _bits in radix_kernel.schedule(num_tiles):
        dest = _counting_pass((rec[column] >> shift) & (radix_kernel.BINS - 1))
        for k, v in rec.items():
            out = torch.empty_like(v)
            out[dest] = v
            rec[k] = out

    def fill(head):
        return torch.cat([head, torch.full((e - n,), SENTINEL, dtype=torch.int64, device=dev)])

    index = elements.index[rec["pay"]] if with_perm else rec["pay"]
    out = SortElements(
        tile=fill(torch.where(rec["tile"] == num_tiles, SENTINEL, rec["tile"])),
        depth=fill(rec["depth"]),
        index=fill(index),
        count=elements.count,
    )
    if with_perm:
        return out, torch.cat([rec["pay"], slot[n:]])
    return out


def sort_elements_xla(elements: SortElements, num_tiles: int, *, with_perm: bool = False):
    """Order the elements by (tile, depth), stably: the radix kernel on CUDA
    tensors, its plain version on CPU tensors.  `elements.count` bounds the
    sorted prefix (None: every slot).  With `with_perm`, also the [E] int64
    slot permutation."""
    if not 0 < num_tiles < 2**31:
        raise ValueError(f"num_tiles {num_tiles} does not fit the sort key")
    if elements.tile.device.type == "cpu":
        return sort_elements_radix_plain(elements, num_tiles, with_perm=with_perm)
    out = radix_kernel.radix_sort(*(x.contiguous() for x in elements[:3]), elements.count,
                                  num_tiles, with_perm=with_perm)
    sorted_el = SortElements(*out[:3], count=elements.count)
    return (sorted_el, out[3]) if with_perm else sorted_el


def sort_elements(elements: SortElements, config: RenderConfig) -> SortElements:
    """Dispatch on the configured sort algorithm."""
    algo = config.sort_algorithm
    if algo in (SortAlgorithm.AUTO, SortAlgorithm.XLA_SORT):
        return sort_elements_xla(elements, config.num_tiles)
    if algo == SortAlgorithm.BITONIC:
        return bitonic.sort_elements_bitonic(elements)
    raise ValueError(f"unknown sort algorithm {algo}")
