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
scatter kernel a 8-bit digit (`schedule`): a persistent grid
(`resident_blocks`) whose blocks take their partitions from an atomic
ticket, in order, stage each next partition's records while they rank and
store the current one, and find the earlier partitions' counts by
decoupled look-back.

The columns are int64 tensors holding uint32 values (ops/keygen.py), tiles
below `num_tiles` or SENTINEL; the order is stable, with SENTINEL tiles
last, by the named key (`schedule`): "tile_depth", (tile, depth), or
"tile", the tile alone, for a list keygen expanded from rows already in
depth order.  With the tile key the depth column may be None: the
records are then (tile', payload), two columns where three are (depth,
tile', payload), for a caller that reads no sorted depth, and the depth
comes back None (counted as "radix_two_column").  `count` ([] int64 on
the device, read there) bounds the sorted prefix: the slots past it are
written SENTINEL, unless one of them is not SENTINEL in every column
sorted, in which case every slot is sorted (csrc/radix.cu, "Count
bound").  The inputs are not written; the outputs
and the scratch are new tensors.  Lists of 2^30 slots or more are refused:
a look-back status word holds a count in 30 bits beside its 2-bit flag.
Only contiguous CUDA tensors are taken: ops/sort.py runs the plain version
for CPU tensors, so this module never falls back.  `_build.LAUNCHES`
counts sorts as "radix_sort" and the kernels they launched as
"radix_kernels".

`depth_order` puts keygen's rows (K7's [6, N] columns and their scan) in
the stable order of their depth keys, each with the slots it keeps at the
capacity, the "depth" key's four passes through the same scatter
(csrc/radix.cu, "The rows' depth order"); K1 then expands them into a list
in (depth, id) order.  It runs the kernels for CUDA tensors and
`depth_order_plain` for CPU tensors, is counted as "depth_order" and its
kernels as "radix_kernels"; on a grid whose rows' word holds h in fewer
bits than the grid's height needs (`rows_wide`), also as
"depth_order_wide".  `counting_pass` is the plain model of one
scatter pass's destinations, which the plain versions of both sorts use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# Copies of csrc/radix.cu's constants (`check_kernel_config` holds them to
# the library's): a scatter block is 16 warps, each 16 rounds (ITEMS) of 32
# slots, TILE slots a partition; 8-bit digits; at most 8 passes; the
# scratch's header words; the status words' count bits.
WARPS = 16
ITEMS = 16
TILE = WARPS * ITEMS * 32
DIGIT_BITS = 8
BINS = 1 << DIGIT_BITS
MAX_PASSES = 8
HEADER_WORDS = 16 + MAX_PASSES * BINS
STATUS_COUNT_BITS = 30
MAX_SLOTS = 1 << STATUS_COUNT_BITS
DEPTH_BITS = 32
DEPTH_PASSES = DEPTH_BITS // DIGIT_BITS
# Rows a partition of `depth_order`'s prep and scan (kRowTile).
ROW_TILE = 32 * WARPS * 8
# The keys `radix_sort` takes, as csrc/radix.cu numbers them; "depth" is
# `depth_order`'s.
SORT_KEYS = {"tile_depth": 0, "tile": 1}
# `depth_order`'s kernels: the prep, a scatter a depth digit, the scan.
DEPTH_ORDER_KERNELS = 2 + DEPTH_PASSES
# Rounds whose lanes `counting_pass` compares in one step ([rounds, 32, 32]).
_PLAIN_ROUNDS = 1 << 15
_LANES = 32


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


@functools.cache
def check_kernel_config() -> dict:
    """Raise unless the library's constants equal the module's copies (the
    plain version's destinations and `scratch_words` depend on them).  Once
    a process: a match is kept."""
    got, want = kernel_config(), python_config()
    if got != want:
        raise RuntimeError(f"csrc/radix.cu's constants {got} differ from radix_kernel's {want}")
    return got


def resident_blocks(device: int | None = None) -> int:
    """The scatter's persistent grid on a CUDA device (the current one by
    default): its SMs times the blocks an SM that the kernel's occupancy
    allows.  Each pass launches at most its partitions of them."""
    index = torch.cuda.current_device() if device is None else device
    blocks = _build.load_library().vk3d_radix_resident_blocks(index)
    if blocks < 0:
        raise _build.cuda_error(-blocks, "radix scatter occupancy")
    return blocks


def key_bits(num_tiles: int, key: str = "tile_depth") -> int:
    """Bits of a sort key: tile' in [0, num_tiles] (SENTINEL mapped to
    num_tiles, so one bit more than `RenderConfig.num_tile_bits` when
    num_tiles is a power of two), above the 32 depth bits for
    "tile_depth"; the 32 depth bits alone for "depth"."""
    if key not in (*SORT_KEYS, "depth"):
        raise ValueError(f"unknown sort key {key!r}")
    return (0 if key == "tile" else DEPTH_BITS) + (0 if key == "depth" else num_tiles.bit_length())


def schedule(num_tiles: int, key: str = "tile_depth") -> list[tuple[str, int, int]]:
    """The digit passes of `key`, least significant first: (the column
    holding the digit, "depth" or "tile", its shift in that column, its
    used bits)."""
    bits = key_bits(num_tiles, key)
    low = 0 if key == "tile" else DEPTH_BITS
    return [("depth", lo, DIGIT_BITS) if lo < low
            else ("tile", lo - low, min(DIGIT_BITS, bits - lo))
            for lo in range(0, bits, DIGIT_BITS)]


def planned_kernels(num_tiles: int, counted: bool = True, key: str = "tile_depth") -> int:
    """Kernels one sort launches: the setup (with a count), the histogram,
    then a scatter a pass."""
    return int(counted) + 1 + len(schedule(num_tiles, key))


def _words4(k: int) -> int:
    """k words rounded up to a multiple of 4 (16 B)."""
    return -(-k // 4) * 4


def scratch_words(e: int, num_tiles: int, key: str = "tile_depth") -> int:
    """uint32 words of scratch for `e` slots: the header (the setup's flag,
    a ticket a pass, the [MAX_PASSES, 256] digit table), the [passes,
    partitions, 256] look-back status words and two [3, e] record
    buffers, each column padded to a multiple of 4 words (16 B)."""
    return HEADER_WORDS + len(schedule(num_tiles, key)) * -(-e // TILE) * BINS + 6 * _words4(e)


def depth_order_scratch_words(n: int) -> int:
    """uint32 words of `depth_order`'s scratch for `n` rows: the header,
    the prep's and the scan's status words (a word a ROW_TILE-row
    partition, each rounded up to 4), the four passes' [partitions, 256]
    status words and two [3, n] record buffers."""
    return (HEADER_WORDS + 2 * _words4(-(-n // ROW_TILE)) + DEPTH_PASSES * -(-n // TILE) * BINS
            + 6 * _words4(n))


def check_depth_column(depth: torch.Tensor | None, key: str) -> None:
    """Only the tile key sorts without a depth column."""
    if depth is None and key != "tile":
        raise ValueError(f"the {key!r} key sorts by the depth column, and it is None")


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def radix_sort(tile: torch.Tensor, depth: torch.Tensor | None, index: torch.Tensor,
               count: torch.Tensor | None, num_tiles: int, *, with_perm: bool = False,
               key: str = "tile_depth"):
    """Sort three [E] int64 contiguous CUDA columns by `key` ("tile_depth":
    (tile, depth); "tile": the tile alone), stably, over the prefix `count`
    bounds (None: every slot); returns the sorted (tile, depth, index), new
    tensors, and with `with_perm` the [E] int64 slot permutation too.
    `depth` None (the "tile" key only): two-column records, and the
    returned depth is None."""
    if not 0 < num_tiles < 2**31:
        raise ValueError(f"num_tiles {num_tiles} does not fit the sort key")
    if key not in SORT_KEYS:
        raise ValueError(f"unknown sort key {key!r}")
    check_depth_column(depth, key)
    e = tile.shape[0]
    if e >= MAX_SLOTS:
        raise ValueError(f"{e} slots do not fit the look-back status words' "
                         f"{STATUS_COUNT_BITS}-bit counts")
    for name, x in (("tile", tile), ("depth", depth), ("index", index)):
        if x is None:
            continue
        if x.dim() != 1 or x.dtype != torch.int64 or x.shape[0] != e:
            raise ValueError(f"{name} must be [{e}] int64, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if count is not None and (count.dim() != 0 or count.dtype != torch.int64):
        raise ValueError(f"count must be a [] int64, got {tuple(count.shape)} {count.dtype}")
    dev = _build.card_device(tile, depth, index, count)
    out = [None if x is None else torch.empty_like(x) for x in (tile, depth, index)]
    perm = torch.empty_like(tile) if with_perm else None
    if e:
        check_kernel_config()
        scratch = torch.empty(scratch_words(e, num_tiles, key), dtype=torch.int32, device=dev)
        launched = ctypes.c_int64(0)
        _build.launch(
            "radix_sort", "vk3d_radix_sort", *(_ptr(x) for x in (tile, depth, index, count)),
            e, num_tiles, SORT_KEYS[key], scratch.data_ptr(), *(_ptr(x) for x in (*out, perm)),
            ctypes.byref(launched), device=dev,
        )
        _build.LAUNCHES["radix_kernels"] += launched.value
        if depth is None:
            _build.LAUNCHES["radix_two_column"] += 1
    return (*out, perm) if with_perm else tuple(out)


def counting_pass(digit: torch.Tensor) -> torch.Tensor:
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
    nparts = -(-n // TILE)
    # Pad to whole partitions; a pad slot has digit BINS, no bin.
    d = torch.cat([digit, digit.new_full((nparts * TILE - n,), BINS)])
    lanes = d.view(-1, _LANES)
    lower = torch.ones(_LANES, _LANES, dtype=torch.bool, device=dev).tril(-1)
    below = torch.cat([((r[:, :, None] == r[:, None, :]) & lower).sum(2)
                       for r in lanes.split(_PLAIN_ROUNDS)]).view(-1)
    nrounds = lanes.shape[0]
    rnd = torch.arange(nrounds, device=dev).repeat_interleave(_LANES)
    hist = torch.bincount(rnd * (BINS + 1) + d, minlength=nrounds * (BINS + 1))
    per_warp = hist.view(-1, ITEMS, BINS + 1)[..., :BINS]
    round_before = (per_warp.cumsum(1) - per_warp).reshape(nrounds, BINS)
    per_part = per_warp.sum(1).view(nparts, WARPS, BINS)
    warp_before = (per_part.cumsum(1) - per_part).reshape(-1, BINS)
    table = per_part.sum(1).T  # [bins, nparts]: each partition's count of each bin
    before = table.cumsum(1) - table
    totals = table.sum(1)
    base = totals.cumsum(0) - totals
    slot = torch.arange(n, device=dev)
    warp = slot // (_LANES * ITEMS)
    return (base[digit] + before[digit, slot // TILE] + warp_before[warp, digit]
            + round_before[slot // _LANES, digit] + below[:n])


def h_bits(grid_width: int, grid_height: int) -> int:
    """The bits left for h in `depth_order`'s packed record word, above
    min_x and max(w, 1) (bit_length(grid_width) bits each) and min_y
    (bit_length(grid_height))."""
    return 32 - 2 * grid_width.bit_length() - grid_height.bit_length()


def rows_pack(grid_width: int, grid_height: int) -> bool:
    """Whether `depth_order` takes the grid: its packed record word keeps
    at least one bit for h, 2 bit_length(grid_width) +
    bit_length(grid_height) <= 31.  That holds for every grid up to 1023
    tiles wide and 2047 high (8K UHD is 480 x 270 tiles, a native 5187 x
    3361 frame 325 x 211, 16K 960 x 540) and up to 2047 wide at 511 high.
    Larger grids keep keygen's index order and the full key."""
    return h_bits(grid_width, grid_height) >= 1


def rows_wide(grid_width: int, grid_height: int) -> bool:
    """Whether the word's h field is narrower than h can be, bit_length(
    grid_height + 1) bits: then a row whose h is at or above the field's
    all-ones marker is marked, and the last pass reads its kept count from
    the scan.  Grids up to 4K UHD's 240 x 135 tiles hold every h; a native
    5187 x 3361 frame's 325 x 211 keeps 6 bits (h up to 62 tiles), 8K
    UHD's 480 x 270 keeps 5 (up to 30)."""
    return rows_pack(grid_width, grid_height) and h_bits(grid_width, grid_height) < (
        grid_height + 1).bit_length()


def _check_rows(cols: torch.Tensor, cum: torch.Tensor, capacity: int, grid_width: int,
                grid_height: int) -> None:
    if cols.dim() != 2 or cols.shape[0] != 6 or cols.dtype != torch.int32:
        raise ValueError(f"cols must be keygen's [6, N] int32 rows, got {tuple(cols.shape)} "
                         f"{cols.dtype}")
    if cum.dim() != 1 or cum.dtype != torch.int64 or cum.shape[0] != cols.shape[1]:
        raise ValueError(f"cum must be [{cols.shape[1]}] int64, got {tuple(cum.shape)} {cum.dtype}")
    if cols.shape[1] >= MAX_SLOTS or not 0 <= capacity < MAX_SLOTS:
        raise ValueError(f"{cols.shape[1]} rows at capacity {capacity} do not fit the look-back "
                         f"status words' {STATUS_COUNT_BITS}-bit counts")
    if grid_width <= 0 or grid_height <= 0 or not rows_pack(grid_width, grid_height):
        raise ValueError(f"a {grid_width} x {grid_height} tile grid does not fit the rows' "
                         "packed word")


def pack_rows_plain(cols: torch.Tensor, cum: torch.Tensor, capacity: int, grid_width: int,
                    grid_height: int):
    """csrc/radix.cu's prep of the record word, in torch ops, to count the
    rows it marks: each row's kept slots, min(cum, E) - min(cum - count,
    E), and the word holding min_x, min_y, max(w, 1) and h = kept / max(w,
    1), or the h field's all-ones marker where the row keeps part of its
    count, its count is not max(w, 1) h, or h does not fit below the
    marker.  Returns (kept, word) as [N] int64.  `depth_order_plain` needs
    none of it: the last pass reads a marked row's kept count from the
    scan, so every row leaves with its own columns and kept count."""
    bx, by = grid_width.bit_length(), grid_height.bit_length()
    shift = 2 * bx + by
    marker = 0xFFFFFFFF >> shift
    c = cols.to(torch.int64)
    gw, min_x, min_y = c[2], c[3], c[4]
    end = cum.clamp(max=capacity)
    kept = end - torch.cat([end.new_zeros(1), end[:-1]])
    count = cum - torch.cat([cum.new_zeros(1), cum[:-1]])
    h = torch.where(gw > 0, kept // gw.clamp(min=1), marker)
    whole = (count == kept) & (gw > 0) & (h * gw == kept) & (h < marker)
    h = torch.where(whole, h, marker)
    word = (min_x | (min_y << bx) | (gw << (bx + by)) | (h << shift)) & 0xFFFFFFFF
    return kept, word


def depth_order_plain(cols: torch.Tensor, cum: torch.Tensor, capacity: int):
    """`depth_order`'s plain version: each row's kept slots, min(cum, E) -
    min(cum - count, E); the rows that keep any, in id order, sorted by one
    `counting_pass` a digit of the "depth" key; their columns, the kept
    counts' exclusive scan in place of the offsets, and the inclusive scan.
    The columns of the rows past them are zeros (the kernel leaves them
    unset)."""
    n = cols.shape[1]
    end = cum.clamp(max=capacity)
    kept = end - torch.cat([end.new_zeros(1), end[:-1]])
    rows = torch.nonzero(kept > 0).flatten()
    key = cols[5].to(torch.int64) & 0xFFFFFFFF
    for _column, shift, _bits in schedule(0, "depth"):
        dest = counting_pass((key[rows] >> shift) & (BINS - 1))
        out = torch.empty_like(rows)
        out[dest] = rows
        rows = out
    m = rows.shape[0]
    kept_d = torch.zeros(n, dtype=torch.int64, device=cols.device)
    kept_d[:m] = kept[rows]
    cum_d = torch.cumsum(kept_d, 0)
    cols_d = torch.zeros_like(cols)
    cols_d[:, :m] = cols[:, rows]
    cols_d[1] = (cum_d - kept_d).to(torch.int32)
    return cols_d, cum_d


def _launch_depth_order(cols: torch.Tensor, cum: torch.Tensor, capacity: int, grid_width: int,
                        grid_height: int):
    dev = _build.card_device(cols, cum)
    cols, cum = cols.contiguous(), cum.contiguous()
    n = cols.shape[1]
    out_cols = torch.empty_like(cols)
    out_cum = torch.empty_like(cum)
    if n:
        check_kernel_config()
        scratch = torch.empty(depth_order_scratch_words(n), dtype=torch.int32, device=dev)
        launched = ctypes.c_int64(0)
        _build.launch("depth_order", "vk3d_radix_depth_order", cols.data_ptr(), cum.data_ptr(),
                      n, capacity, grid_width, grid_height, scratch.data_ptr(),
                      out_cols.data_ptr(), out_cum.data_ptr(), ctypes.byref(launched),
                      device=dev)
        _build.LAUNCHES["radix_kernels"] += launched.value
        if rows_wide(grid_width, grid_height):
            _build.LAUNCHES["depth_order_wide"] += 1
    return out_cols, out_cum


def depth_order(cols: torch.Tensor, cum: torch.Tensor, capacity: int, grid_width: int,
                grid_height: int):
    """keygen's rows in the stable order of their depth keys, for K1.

    Args:
      cols: [6, N] int32 rows as K7 writes them (id = the row's index,
        offset, max(w, 1), min_x, min_y, the depth key's bits).
      cum: [N] int64 inclusive scan of the counts (`Projection.cum`).
      capacity: slot capacity E; a row keeps its share of [0, E) in the
        index-order expansion.
      grid_width, grid_height: the tile grid (`rows_pack` must hold;
        `rows_wide`: h narrower than the grid's height, counted as
        "depth_order_wide").

    Returns (cols, cum) in that order: the rows that keep a slot first,
    each with the exclusive scan of the kept counts as its offset, and the
    [N] int64 inclusive scan of the kept counts; rows past them keep 0
    slots.  CUDA tensors launch csrc/radix.cu's kernels (counted as
    "depth_order"), CPU tensors run `depth_order_plain`.
    """
    card = _build.on_card(cols, cum)
    _check_rows(cols, cum, capacity, grid_width, grid_height)
    if card:
        return _launch_depth_order(cols, cum, capacity, grid_width, grid_height)
    return depth_order_plain(cols, cum, capacity)
