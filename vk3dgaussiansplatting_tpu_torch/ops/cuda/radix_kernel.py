"""One-sweep LSD radix sort of (tile, depth, index) — the wrapper of
csrc/radix.cu.

Not a TPU kernel: it replaces the JAX package's two `jax.lax.sort` calls
on the sort elements, vk3dgaussiansplatting_tpu/ops/sort.py:37
sort_elements_xla and parallel/dist.py:195 _sort3, with the reference's
GPU sort, an LSD radix sort over the used key bits (RadixSort.cpp), in
the one-sweep form (Adinets & Merrill, arXiv:2206.01784).  One call of
the C entry point runs the whole sort on the current stream: with a count,
a setup kernel over the slots past it; one histogram kernel that counts
every digit's bins in one read of the key columns; then one chained-scan
scatter kernel a 8-bit digit (`schedule`), whose blocks take their
partitions from an atomic ticket and find the earlier partitions' counts
by decoupled look-back.

The columns are int64 tensors holding uint32 values (ops/keygen.py), tiles
below `num_tiles` or SENTINEL; the order is (tile, depth), stable, with
SENTINEL tiles last.  `count` ([] int64 on the device, read there) bounds
the sorted prefix: the slots past it are written SENTINEL, unless one of
them is not a SENTINEL triple, in which case every slot is sorted
(csrc/radix.cu, "Count bound").  The inputs are not written; the outputs
and the scratch are new tensors.  Lists of 2^30 slots or more are refused:
a look-back status word holds a count in 30 bits beside its 2-bit flag.
Only contiguous CUDA tensors are taken: ops/sort.py runs the plain version
for CPU tensors, so this module never falls back.  `LAUNCHES` counts sorts,
`PASSES` the kernels they launched.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0
PASSES = 0
# Copies of csrc/radix.cu's constants (`check_kernel_config` holds them to
# the library's): a scatter block is 12 warps, each 16 rounds (ITEMS) of 32
# slots, TILE slots a partition; 8-bit digits; at most 8 passes; the
# scratch's header words; the status words' count bits.
WARPS = 12
ITEMS = 16
TILE = WARPS * ITEMS * 32
DIGIT_BITS = 8
BINS = 1 << DIGIT_BITS
MAX_PASSES = 8
HEADER_WORDS = 16 + MAX_PASSES * BINS
STATUS_COUNT_BITS = 30
MAX_SLOTS = 1 << STATUS_COUNT_BITS
DEPTH_BITS = 32
_config_checked = False


def kernel_config() -> dict:
    """csrc/radix.cu's constants as the built library reports them
    (`vk3d_radix_config`)."""
    names = ("threads", "items", "digit_bits", "max_passes", "header_words",
             "status_count_bits")
    out = (ctypes.c_int32 * len(names))()
    _build.load_library().vk3d_radix_config(out, len(names))
    return dict(zip(names, out))


def python_config() -> dict:
    """The module's copies of those constants."""
    return {"threads": 32 * WARPS, "items": ITEMS, "digit_bits": DIGIT_BITS,
            "max_passes": MAX_PASSES, "header_words": HEADER_WORDS,
            "status_count_bits": STATUS_COUNT_BITS}


def check_kernel_config() -> dict:
    """Raise unless the library's constants equal the module's copies (the
    plain version's destinations and `scratch_words` depend on them)."""
    got, want = kernel_config(), python_config()
    if got != want:
        raise RuntimeError(f"csrc/radix.cu's constants {got} differ from radix_kernel's {want}")
    return got


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
    """Kernels one sort launches: the setup (with a count), the histogram,
    then a scatter a pass."""
    return int(counted) + 1 + len(schedule(num_tiles))


def scratch_words(e: int, num_tiles: int) -> int:
    """uint32 words of scratch for `e` slots: the header (the setup's flag,
    a ticket a pass, the [MAX_PASSES, 256] digit table), the [passes,
    partitions, 256] look-back status words and two [3, e] record
    buffers, each column padded to a multiple of 4 words (16 B)."""
    return HEADER_WORDS + len(schedule(num_tiles)) * -(-e // TILE) * BINS + 6 * (-(-e // 4) * 4)


def radix_sort(tile: torch.Tensor, depth: torch.Tensor, index: torch.Tensor,
               count: torch.Tensor | None, num_tiles: int, *, with_perm: bool = False):
    """Sort three [E] int64 contiguous CUDA columns by (tile, depth),
    stably, over the prefix `count` bounds (None: every slot); returns the
    sorted (tile, depth, index), new tensors, and with `with_perm` the
    [E] int64 slot permutation too."""
    global LAUNCHES, PASSES, _config_checked
    if not 0 < num_tiles < 2**31:
        raise ValueError(f"num_tiles {num_tiles} does not fit the sort key")
    e = tile.shape[0]
    if e >= MAX_SLOTS:
        raise ValueError(f"{e} slots do not fit the look-back status words' "
                         f"{STATUS_COUNT_BITS}-bit counts")
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
    out = [torch.empty_like(tile) for _ in range(3)]
    perm = torch.empty_like(tile) if with_perm else None
    if e:
        if not _config_checked:
            check_kernel_config()
            _config_checked = True
        dev = tile.device
        scratch = torch.empty(scratch_words(e, num_tiles), dtype=torch.int32, device=dev)
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
