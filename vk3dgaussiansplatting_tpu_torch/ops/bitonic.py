"""Bitonic merge sort tier — port of `vk3dgaussiansplatting_tpu.ops.bitonic`.

The reference selects between RadixSort and BitonicMergeSort at compile time
(`GPU_SORT_ALGORITHM`, Renderer.h:33); its bitonic path runs LOCAL_BMS /
BIG_FLIP / BIG_DISPERSE / LOCAL_DISPERSE dispatches over a power-of-two
element buffer (BitonicMergeSort.cpp:103-149).  The JAX package writes the
same compare-exchange network as one XLA fusion a stage, dropping the
shared-memory split.  On CPU tensors the port runs
`sort_elements_bitonic_plain`, the JAX stage schedule in torch ops.  On
CUDA tensors it runs a kernel (ops/cuda/bitonic_kernel.py,
csrc/bitonic.cu) that departs from the reference's dispatch schedule: the
network in its XOR form (slot i against i ^ j, ascending where i & k == 0),
blocks of 2^13 elements in shared memory, and the global distances of each
k fused five to a pass in registers — 30 kernels a sort at 2^24 slots
where the reference's schedule takes 105.  Its stages differ from the JAX
tier's; the sorted array, the only thing either returns, does not.

The order is lexicographic on (tile, depth, index), the uint32 values the
port carries in int64 tensors (ops/keygen.py).  SENTINEL is the largest
value of each column, and the index breaks (tile, depth) ties, so the
result equals the stable tier's (ops/sort.py) on keygen's lists, where ids
ascend in slot order within a (tile, depth) pair.

Requires a power-of-two capacity, like the reference (`assert` at
BitonicMergeSort.cpp:68); the default capacity formula gives one.
"""

from __future__ import annotations

import torch

from .cuda import bitonic_kernel
from .keygen import SortElements


def _key_less(t0, d0, i0, t1, d1, i1):
    """Lexicographic (tile, depth, index) comparison."""
    return (t0 < t1) | ((t0 == t1) & ((d0 < d1) | ((d0 == d1) & (i0 < i1))))


def _compare_exchange(lo, hi):
    """The smaller triple of each (lo, hi) pair to lo: new (lo, hi) lists."""
    swap = ~_key_less(*lo, *hi)
    return ([torch.where(swap, h, l) for l, h in zip(lo, hi)],
            [torch.where(swap, l, h) for l, h in zip(lo, hi)])


def sort_elements_bitonic_plain(elements: SortElements) -> SortElements:
    """The network stage by stage (JAX bitonic.py:47-101): for each block
    size k, the flip (each k-block's mirrored pairs), then the disperses at
    distances k/4 .. 1."""
    cols = [elements.tile, elements.depth, elements.index]
    e = cols[0].shape[0]
    k = 2
    while k <= e:
        # "Flip": slot q of each k-block against slot k - 1 - q.
        blocks = [c.reshape(-1, k) for c in cols]
        lo, hi = _compare_exchange([b[:, : k // 2] for b in blocks],
                                   [b[:, k // 2 :].flip(1) for b in blocks])
        cols = [torch.cat([l, h.flip(1)], dim=1).reshape(-1) for l, h in zip(lo, hi)]
        # "Disperse": distance j, j halving.
        j = k // 4
        while j >= 1:
            pairs = [c.reshape(-1, 2, j) for c in cols]
            lo, hi = _compare_exchange([p[:, 0] for p in pairs], [p[:, 1] for p in pairs])
            cols = [torch.stack([l, h], dim=1).reshape(-1) for l, h in zip(lo, hi)]
            j //= 2
        k *= 2
    return SortElements(tile=cols[0], depth=cols[1], index=cols[2], count=elements.count)


def sort_elements_bitonic(elements: SortElements) -> SortElements:
    """Order the elements by (tile, depth, index): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    e = elements.tile.shape[0]
    if e & (e - 1):
        raise ValueError(
            f"bitonic sort requires a power-of-two capacity, got {e} "
            "(reference: BitonicMergeSort.cpp:68)"
        )
    if elements.tile.device.type == "cpu":
        return sort_elements_bitonic_plain(elements)
    tile, depth, index = bitonic_kernel.bitonic_sort(elements.tile, elements.depth, elements.index)
    return SortElements(tile=tile, depth=depth, index=index, count=elements.count)
