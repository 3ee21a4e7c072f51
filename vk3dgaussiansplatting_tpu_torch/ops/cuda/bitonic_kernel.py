"""Bitonic merge sort of (tile, depth, index) — the wrapper of csrc/bitonic.cu.

Replaces vk3dgaussiansplatting_tpu/ops/bitonic.py:sort_elements_bitonic (an
XLA function of the JAX package, not a Pallas kernel).  One call of the C
entry point runs the whole network on the current stream, in its XOR form
(stage (k, j): slot i against i ^ j, ascending where i & k == 0): one
shared-memory pass sorting each block of `BLOCK` elements, then for each
k = 2·BLOCK .. E the global distances k/2 .. BLOCK fused `GROUP` to a pass
in registers, and one shared-memory pass for the distances below BLOCK
(`schedule`, `planned_passes`).

The columns are int64 tensors holding uint32 values (ops/keygen.py), each
in [0, 2^32); the order is lexicographic on (tile, depth, index).  The
inputs are not written; the outputs are new tensors.  Only CUDA tensors are
taken: ops/bitonic.py runs the plain version for CPU tensors, so this
module never falls back.  `LAUNCHES` counts sorts (calls that launched the
network), `PASSES` the kernels those sorts launched.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0
PASSES = 0
# Elements a block sorts in shared memory (csrc/bitonic.cu's kLogBlock):
# 2^13, 12 B each in 96 KB of dynamic shared memory, 256 threads holding 32
# elements each, two blocks an SM in a merge.
BLOCK = 1 << 13
# Global distances fused into one pass, 2^GROUP elements a thread
# (csrc/bitonic.cu's kGroup); five keep a sort at 2^24 to 30 kernels.
GROUP = 5


def _halving(hi: int, lo: int) -> list[int]:
    out = []
    while hi >= lo:
        out.append(hi)
        hi //= 2
    return out


def schedule(e: int, block: int = BLOCK,
             group: int = GROUP) -> list[tuple[str, list[tuple[int, int]]]]:
    """The kernels csrc/bitonic.cu launches for `e` elements (a power of
    two), in order: each (kind, its stages (k, j) in order).  Kinds:
    "first" sorts each block of `block` elements from the columns (a lone
    shorter block padded with all-ones triples), "global" fuses up to
    `group` distances >= block of one k, "merge" runs the distances below
    block of one k.  A `block` or `group` other than the kernel's serves the
    numpy model of the passes."""
    if e <= 0:
        return []
    first, k = [], 2
    while k <= block:
        first += [(k, j) for j in _halving(k // 2, 1)]
        k *= 2
    passes = [("first", first)]
    k = 2 * block
    while k <= e:
        dist = _halving(k // 2, block)
        passes += [("global", [(k, j) for j in dist[i : i + group]])
                   for i in range(0, len(dist), group)]
        passes.append(("merge", [(k, j) for j in _halving(block // 2, 1)]))
        k *= 2
    return passes


def planned_passes(e: int, block: int = BLOCK, group: int = GROUP) -> int:
    """Kernel launches of one sort of `e` elements."""
    return len(schedule(e, block, group))


def bitonic_sort(tile: torch.Tensor, depth: torch.Tensor, index: torch.Tensor):
    """Sort three [E] int64 CUDA columns (E a power of two) by (tile, depth,
    index); returns the sorted (tile, depth, index), new tensors."""
    global LAUNCHES, PASSES
    e = tile.shape[0]
    for name, x in (("tile", tile), ("depth", depth), ("index", index)):
        if x.dim() != 1 or x.dtype != torch.int64 or x.shape[0] != e:
            raise ValueError(f"{name} must be [{e}] int64, got {tuple(x.shape)} {x.dtype}")
        if x.device != tile.device:
            raise ValueError("tile, depth and index must be on one device")
    if e & (e - 1):
        raise ValueError(f"bitonic sort requires a power-of-two length, got {e}")
    if tile.device.type != "cuda":
        raise ValueError(f"unsupported device {tile.device}")
    cols = [x.contiguous() for x in (tile, depth, index)]
    out = [torch.empty_like(x) for x in cols]
    if e == 0:
        return tuple(out)
    dev = tile.device
    keys = torch.empty(e, dtype=torch.int64, device=dev) if e > BLOCK else None
    idx = torch.empty(e, dtype=torch.int32, device=dev) if e > BLOCK else None
    launched = ctypes.c_int64(0)
    err = _build.load_library().vk3d_bitonic_sort(
        *(x.data_ptr() for x in cols), e,
        None if keys is None else keys.data_ptr(), None if idx is None else idx.data_ptr(),
        *(x.data_ptr() for x in out), ctypes.byref(launched),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(err, "bitonic_sort")
    LAUNCHES += 1
    PASSES += launched.value
    return tuple(out)
