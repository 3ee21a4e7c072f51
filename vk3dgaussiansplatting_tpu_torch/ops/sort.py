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
the same counts directly (`radix_kernel.counting_pass`), so the two give
the same destinations.

The key is tile' above the 32 depth bits, where tile' maps the SENTINEL
tile 0xFFFFFFFF to `num_tiles` (above every live tile, as the JAX sort maps
it to 0xFFFF): 32 + bit_length(num_tiles) bits, 8 a pass
(`radix_kernel.schedule`).  Every pass is stable, so ties keep slot order:
within one (tile, depth) pair keygen's gaussian ids ascend with slot order,
so that is JAX's 3-key (tile, depth, index) order.  Sentinel slots are
all-equal.

The frame's sort (`depth_first`) splits that key in two.  keygen puts its
rows in depth order before the expansion (`radix_kernel.depth_order`, 32
bits over the gaussians that keep a slot), so its list is in (depth, id)
order already, each gaussian's tiles row-major; the sort then keys tile'
alone (key "tile", 2 passes at 720p and 1080p, 3 at a native 5187 x 3361
frame's 68,575 tiles), and its stable order is
the same (tile, depth, index) order, as a gaussian touches a tile at most
once.  The bitonic sort and the distributed frame's received lists
(parallel/dist.py `_sort3`) keep the index order and the full key.  A
caller that reads no sorted depth (the uncapped frame: its ranges read the
tile, its blend the index) hands the tile-key sort a list whose depth is
None; the sort then carries (tile', index) records, two columns where it
carries three, and returns the depth None.

`count` bounds the sorted prefix: slots at and past it are written as
SENTINEL, as keygen's lists hold there; where an input slot there is not
SENTINEL in every column sorted, every slot is sorted, so the result is
always the stable sort of the whole list.

`SortAlgorithm.BITONIC` selects the reference's other sort, the bitonic
merge network (ops/bitonic.py, a CUDA kernel on the card), which gives the
same order at a power-of-two capacity.
"""

from __future__ import annotations

import torch

from ..core.config import SENTINEL, RenderConfig, SortAlgorithm
from . import bitonic
from .cuda import _build, radix_kernel
from .keygen import SortElements


def _sorted_len(elements: SortElements) -> int:
    """The sorted prefix: min(count, E), or E without a count or when a slot
    past the count is not SENTINEL in every column sorted (csrc/radix.cu's
    setup)."""
    e = elements.tile.shape[0]
    if elements.count is None:
        return e
    n = min(max(int(elements.count), 0), e)
    tail = [x[n:] for x in elements[:3] if x is not None]
    return n if all(bool((x == SENTINEL).all()) for x in tail) else e


def sort_elements_radix_plain(elements: SortElements, num_tiles: int, *,
                              with_perm: bool = False, key: str = "tile_depth"):
    """csrc/radix.cu in torch ops: the key map, the count bound and the
    sentinel fill, then one stable counting pass a digit of
    `radix_kernel.schedule(num_tiles, key)`.  `elements.count` None sorts every
    slot; `elements.depth` None (the "tile" key only) sorts two columns and
    returns the depth None.  Returns the sorted SortElements and, with
    `with_perm`, the [E] int64 slot permutation."""
    radix_kernel.check_depth_column(elements.depth, key)
    e = elements.tile.shape[0]
    dev = elements.tile.device
    n = _sorted_len(elements)
    t = elements.tile[:n]
    slot = torch.arange(e, device=dev)
    # The records: (depth,) tile' and the payload (the slot, or the id).
    rec = {"tile": torch.where(t == SENTINEL, num_tiles, t),
           "pay": slot[:n] if with_perm else elements.index[:n]}
    if elements.depth is not None:
        rec["depth"] = elements.depth[:n]
    for column, shift, _bits in radix_kernel.schedule(num_tiles, key):
        dest = radix_kernel.counting_pass((rec[column] >> shift) & (radix_kernel.BINS - 1))
        for k, v in rec.items():
            out = torch.empty_like(v)
            out[dest] = v
            rec[k] = out

    def fill(head):
        return torch.cat([head, torch.full((e - n,), SENTINEL, dtype=torch.int64, device=dev)])

    index = elements.index[rec["pay"]] if with_perm else rec["pay"]
    out = SortElements(
        tile=fill(torch.where(rec["tile"] == num_tiles, SENTINEL, rec["tile"])),
        depth=fill(rec["depth"]) if "depth" in rec else None,
        index=fill(index),
        count=elements.count,
    )
    if with_perm:
        return out, torch.cat([rec["pay"], slot[n:]])
    return out


def sort_elements_xla(elements: SortElements, num_tiles: int, *, with_perm: bool = False,
                      key: str = "tile_depth"):
    """Order the elements by `key` (`radix_kernel.schedule`: "tile_depth",
    (tile, depth); "tile", the tile alone), stably: the radix kernel on CUDA
    tensors, its plain version on CPU tensors.  `elements.count` bounds the
    sorted prefix (None: every slot); `elements.depth` None (the "tile" key
    only) sorts (tile, index) alone and returns the depth None.  With
    `with_perm`, also the [E] int64 slot permutation."""
    if not 0 < num_tiles < 2**31:
        raise ValueError(f"num_tiles {num_tiles} does not fit the sort key")
    if not _build.on_card(*elements):
        return sort_elements_radix_plain(elements, num_tiles, with_perm=with_perm, key=key)
    out = radix_kernel.radix_sort(*(None if x is None else x.contiguous() for x in elements[:3]),
                                  elements.count, num_tiles, with_perm=with_perm, key=key)
    sorted_el = SortElements(*out[:3], count=elements.count)
    return (sorted_el, out[3]) if with_perm else sorted_el


def depth_first(config: RenderConfig) -> bool:
    """Whether the frame's keygen puts its rows in depth order and its sort
    keys the tile alone: the radix sort, on a tile grid whose extents fit
    the rows' packed word (`radix_kernel.rows_pack`: 2 bit_length(grid
    width) + bit_length(grid height) <= 31, every grid up to 1023 x 2047
    tiles, 8K UHD's 480 x 270 and a native 5187 x 3361 frame's 325 x 211
    among them).  Larger grids keep the index order and the full key.  The
    bitonic network's cost does not depend on its input's order, so it
    keeps the index order."""
    return (config.sort_algorithm in (SortAlgorithm.AUTO, SortAlgorithm.XLA_SORT)
            and radix_kernel.rows_pack(config.grid_width, config.grid_height))


def sort_elements(elements: SortElements, config: RenderConfig, timer=None, *,
                  depth_ordered: bool = False) -> SortElements:
    """Dispatch on the configured sort algorithm.  `depth_ordered`: the
    list is keygen's expansion of its rows in depth order
    (`depth_first`), so the radix sort keys the tile alone, and may be
    handed no depth column.  `timer` reaches the bitonic tier's passes;
    the radix sort takes none."""
    algo = config.sort_algorithm
    if algo in (SortAlgorithm.AUTO, SortAlgorithm.XLA_SORT):
        return sort_elements_xla(elements, config.num_tiles,
                                 key="tile" if depth_ordered else "tile_depth")
    if algo == SortAlgorithm.BITONIC:
        return bitonic.sort_elements_bitonic(elements, timer=timer)
    raise ValueError(f"unknown sort algorithm {algo}")
