"""LSD radix sort of (tile, depth, index) — the wrapper of csrc/radix.cu.

Not a TPU kernel: it replaces the JAX package's two `jax.lax.sort` calls
on the sort elements, vk3dgaussiansplatting_tpu/ops/sort.py:37
sort_elements_xla and parallel/dist.py:195 _sort3, with the reference's
GPU sort, an LSD radix sort over the used key bits (RadixSort.cpp).  One
call of the C entry point runs the whole sort on the current stream: with
a count, a setup kernel over the slots past it; then per 8-bit digit
(`schedule`) a histogram, a scan and a stable scatter kernel.

The columns are int64 tensors holding uint32 values (ops/keygen.py), tiles
below `num_tiles` or SENTINEL; the order is (tile, depth), stable, with
SENTINEL tiles last.  `count` ([] int64 on the device, read there) bounds
the sorted prefix: the slots past it are written SENTINEL, unless one of
them is not a SENTINEL triple, in which case every slot is sorted
(csrc/radix.cu, "Count bound").  The inputs are not written; the outputs
and the scratch are new tensors.  Only contiguous CUDA tensors are taken:
ops/sort.py runs the plain version for CPU tensors, so this module never
falls back.  `LAUNCHES` counts sorts, `PASSES` the kernels they launched.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0
PASSES = 0
# Slots a block of the histogram and scatter kernels takes (csrc/radix.cu's
# kTile): 8 warps, each 16 rounds (ITEMS, csrc/radix.cu's kItems) of 32
# slots; and the digit's width and bins.
WARPS = 8
ITEMS = 16
TILE = WARPS * ITEMS * 32
DIGIT_BITS = 8
BINS = 1 << DIGIT_BITS
DEPTH_BITS = 32


def key_bits(num_tiles: int) -> int:
    """Bits of the sort key: the 32 depth bits under tile' in [0,
    num_tiles] (SENTINEL mapped to num_tiles, so one bit more than
    `RenderConfig.num_tile_bits` when num_tiles is a power of two)."""
    return DEPTH_BITS + num_tiles.bit_length()


def schedule(num_tiles: int) -> list[tuple[str, int, int]]:
    """The digit passes, least significant first: (the column holding the
    digit, "depth" or "tile", its shift in that column, its used bits)."""
    bits = key_bits(num_tiles)
    return [("depth", lo, DIGIT_BITS) if lo < DEPTH_BITS
            else ("tile", lo - DEPTH_BITS, min(DIGIT_BITS, bits - lo))
            for lo in range(0, bits, DIGIT_BITS)]


def planned_kernels(num_tiles: int, counted: bool = True) -> int:
    """Kernels one sort launches: the setup (with a count), then a
    histogram, a scan and a scatter a pass."""
    return int(counted) + 3 * len(schedule(num_tiles))


def scratch_words(e: int) -> int:
    """uint32 words of scratch for `e` slots: two [3, e] record buffers, the
    [256, nblocks] digit table, the 256 bin totals and the setup's flag."""
    return 6 * e + BINS * -(-e // TILE) + BINS + 1


def radix_sort(tile: torch.Tensor, depth: torch.Tensor, index: torch.Tensor,
               count: torch.Tensor | None, num_tiles: int, *, with_perm: bool = False):
    """Sort three [E] int64 contiguous CUDA columns by (tile, depth),
    stably, over the prefix `count` bounds (None: every slot); returns the
    sorted (tile, depth, index), new tensors, and with `with_perm` the
    [E] int64 slot permutation too."""
    global LAUNCHES, PASSES
    if not 0 < num_tiles < 2**31:
        raise ValueError(f"num_tiles {num_tiles} does not fit the sort key")
    e = tile.shape[0]
    for name, x in (("tile", tile), ("depth", depth), ("index", index)):
        if x.dim() != 1 or x.dtype != torch.int64 or x.shape[0] != e:
            raise ValueError(f"{name} must be [{e}] int64, got {tuple(x.shape)} {x.dtype}")
        if x.device != tile.device:
            raise ValueError("tile, depth and index must be on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if count is not None and (count.dim() != 0 or count.dtype != torch.int64
                              or count.device != tile.device):
        raise ValueError(f"count must be a [] int64 on {tile.device}, got "
                         f"{tuple(count.shape)} {count.dtype} on {count.device}")
    if tile.device.type != "cuda":
        raise ValueError(f"unsupported device {tile.device}")
    if e >= 2**31:
        raise ValueError(f"{e} slots do not fit the kernel's 32-bit slots")
    out = [torch.empty_like(tile) for _ in range(3)]
    perm = torch.empty_like(tile) if with_perm else None
    if e:
        dev = tile.device
        scratch = torch.empty(scratch_words(e), dtype=torch.int32, device=dev)
        launched = ctypes.c_int64(0)
        err = _build.load_library().vk3d_radix_sort(
            tile.data_ptr(), depth.data_ptr(), index.data_ptr(),
            None if count is None else count.data_ptr(), e, num_tiles, scratch.data_ptr(),
            *(x.data_ptr() for x in out), None if perm is None else perm.data_ptr(),
            ctypes.byref(launched), dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check_launch(err, "radix_sort")
        LAUNCHES += 1
        PASSES += launched.value
    return (*out, perm) if with_perm else tuple(out)
