"""Bitonic merge sort of (tile, depth, index) — the wrapper of csrc/bitonic.cu.

Replaces vk3dgaussiansplatting_tpu/ops/bitonic.py:sort_elements_bitonic (an
XLA function of the JAX package, not a Pallas kernel).  One call of the C
entry point runs the whole network on the current stream, on the reference
renderer's dispatch schedule: one shared-memory pass sorting each block of
`BLOCK` elements, then for each k = 2·BLOCK .. E a global flip, a global
disperse a distance j with BLOCK <= j <= k/4, and a shared-memory pass for
the distances below BLOCK (`planned_passes`).

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
# Elements a block sorts in shared memory: csrc/bitonic.cu's kBlock
# (2 x 1024 threads, one pair a thread; 24 KB of shared memory).
BLOCK = 2048


def schedule(e: int, block: int = BLOCK) -> list[list[tuple[bool, int]]]:
    """The kernels csrc/bitonic.cu launches for `e` elements (a power of
    two), in order: each the list of its stages, (flip, distance)."""
    if e <= 0:
        return []

    def disperses(hi: int, lo: int) -> list[tuple[bool, int]]:
        out, j = [], hi
        while j >= lo:
            out.append((False, j))
            j //= 2
        return out

    local_sort, k = [], 2  # LOCAL_BMS over blocks of min(e, block)
    while k <= min(e, block):
        local_sort += [(True, k // 2)] + disperses(k // 4, 1)
        k *= 2
    passes = [local_sort]
    k = 2 * block
    while k <= e:
        passes.append([(True, k // 2)])  # BIG_FLIP
        passes += [[stage] for stage in disperses(k // 4, block)]  # BIG_DISPERSE
        passes.append(disperses(block // 2, 1))  # LOCAL_DISPERSE
        k *= 2
    return passes


def planned_passes(e: int) -> int:
    """Kernel launches of one sort of `e` elements."""
    return len(schedule(e))


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
    if tile.device.type != "cuda":
        raise ValueError(f"unsupported device {tile.device}")
    if e & (e - 1):
        raise ValueError(f"bitonic sort requires a power-of-two length, got {e}")
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
        *(x.data_ptr() for x in out), ctypes.byref(launched), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check_launch(err, "bitonic_sort")
    LAUNCHES += 1
    PASSES += launched.value
    return tuple(out)
