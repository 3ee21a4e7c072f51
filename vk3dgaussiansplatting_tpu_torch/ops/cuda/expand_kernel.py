"""Monotone fixed-capacity expansion (K1, K1') — wrappers of csrc/expand.cu.

Replaces vk3dgaussiansplatting_tpu/ops/pallas/expand_kernel.py:expand_rows
(K1) and :expand_rows_streamed (K1').  On the TPU the two differ only in
their DMA schedule: K1' streams windows for the prefilter's thinned counts
(~1 element per source row), and its output is K1's bit for bit.  The CUDA
kernel's merge-path expansion gives every block the same share of row ends
and slots whatever the run lengths, so both wrappers launch it; each keeps
its own launch count, so a run shows which of the two the frame went
through.  One launch is the partition search and the expansion, on the
current stream.  Both read the inclusive int64 scan of the counts, `cum`,
where the TPU functions take the counts: keygen passes the scan K7 wrote
(`Projection.cum`), and another caller scans with `torch.cumsum`.

keygen expands through `expand_elements`: the kernel's decode variant, which
stores the sort elements (tile, depth, index, count) where the rows variant
stores the rows, so the per-slot decode (JAX keygen.py:203-262) costs no
kernel and no read of the rows of its own.  Its plain version is
`decode_slots_plain` over `expand_rows_plain`.

Each wrapper launches the CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors (`_build.on_card`); it never falls back from one to
the other.  `_build.LAUNCHES` counts K1's launches as "expand_rows" and
K1''s as "expand_rows_streamed", in either variant.
"""

from __future__ import annotations

import torch

from ...core.config import SENTINEL
from . import _build
from .keygen_kernel import NUM_COLS

MAX_COLS = 7
# Merged items (row ends and slots) per block of csrc/expand.cu (kItems).
ITEMS_PER_BLOCK = 512


def _check(cols: torch.Tensor, cum: torch.Tensor) -> None:
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise ValueError(f"cols must be [C, N] int32, got {tuple(cols.shape)} {cols.dtype}")
    if not 1 <= cols.shape[0] <= MAX_COLS:
        raise ValueError(f"1..{MAX_COLS} columns supported, got {cols.shape[0]}")
    if cum.dtype != torch.int64 or cum.dim() != 1 or cum.shape[0] != cols.shape[1]:
        raise ValueError(f"cum must be [{cols.shape[1]}] int64 matching cols, got "
                         f"{tuple(cum.shape)} {cum.dtype}")


def expand_rows_plain(cols: torch.Tensor, cum: torch.Tensor, capacity: int):
    """`repeat_interleave` over the columns by the counts `cum` scans,
    truncated or zero-padded to `capacity` slots.  Returns ([C, capacity]
    int32, total [] int64)."""
    _check(cols, cum)
    counts = torch.diff(cum, prepend=cum.new_zeros(1))
    if bool((counts < 0).any()):
        raise ValueError("cum must be an inclusive scan of counts >= 0")
    total = cum[-1] if cum.numel() else cum.new_zeros(())
    rep = torch.repeat_interleave(cols, counts, dim=1)[:, :capacity]
    out = torch.zeros((cols.shape[0], capacity), dtype=torch.int32, device=cols.device)
    out[:, : rep.shape[1]] = rep
    return out, total


def _launch(name: str, cols: torch.Tensor, cum: torch.Tensor, capacity: int):
    dev = _build.card_device(cols, cum)
    _check(cols, cum)
    cols, cum = cols.contiguous(), cum.contiguous()
    total = cum[-1] if cum.numel() else torch.zeros((), dtype=torch.int64, device=dev)
    out = torch.empty((cols.shape[0], capacity), dtype=torch.int32, device=dev)
    nblocks = -(-(cols.shape[1] + capacity) // ITEMS_PER_BLOCK)
    part = torch.empty(nblocks + 1, dtype=torch.int64, device=dev)
    _build.launch(name, "vk3d_expand_rows", cols.data_ptr(), cols.shape[0], cum.data_ptr(),
                  cols.shape[1], capacity, part.data_ptr(), nblocks, out.data_ptr(), device=dev)
    return out, total


def expand_rows(cols: torch.Tensor, cum: torch.Tensor, capacity: int):
    """Expand ≤7 int32 columns of N rows into `capacity` slots, row i
    repeated counts[i] times.

    Args:
      cols: [C, N] int32, one row per column of the packed source rows.
      cum: [N] int64 inclusive scan of the per-row element counts (0 for
        culled rows): `Projection.cum`, or `torch.cumsum(counts, 0)`.  A cum
        that decreases is not checked on the card.
      capacity: slot capacity E.

    Returns (out, total): [C, E] int32 with out[:, j] the row covering slot j
    (zeros past min(total, E)), and the [] int64 unclamped total.
    """
    if _build.on_card(cols, cum):
        return _launch("expand_rows", cols, cum, capacity)
    return expand_rows_plain(cols, cum, capacity)


def expand_rows_streamed(cols: torch.Tensor, cum: torch.Tensor, capacity: int):
    """K1', the expansion under the depth prefilter: `expand_rows`'s
    arguments and result, counted as "expand_rows_streamed"."""
    if _build.on_card(cols, cum):
        return _launch("expand_rows_streamed", cols, cum, capacity)
    return expand_rows_plain(cols, cum, capacity)


def _check_elements(cols: torch.Tensor, cum: torch.Tensor) -> None:
    _check(cols, cum)
    if cols.shape[0] != NUM_COLS:
        raise ValueError(f"cols must be keygen's [{NUM_COLS}, N] rows, got {tuple(cols.shape)}")


def decode_slots_plain(cols: torch.Tensor, total: torch.Tensor, grid_width: int):
    """The per-slot decode: (tile, depth, index, count), the int64 columns of
    SortElements (SENTINEL at and past the count) and the count, from the
    expansion's [6, E] columns and its unclamped total."""
    capacity = cols.shape[1]
    cols = cols.to(torch.int64)
    slot = torch.arange(capacity, device=cols.device, dtype=torch.int64)
    count = torch.clamp(total, max=capacity)
    live = slot < count
    local = slot - cols[1]
    gw_safe = cols[2].clamp(min=1)  # dead slots hold zero rows
    ly = torch.div(local, gw_safe, rounding_mode="floor")
    lx = local - ly * gw_safe
    tile_key = (cols[4] + ly) * grid_width + (cols[3] + lx)
    return (torch.where(live, tile_key, SENTINEL),
            torch.where(live, cols[5] & 0xFFFFFFFF, SENTINEL),
            torch.where(live, cols[0], SENTINEL),
            count)


def expand_elements_plain(cols: torch.Tensor, cum: torch.Tensor, capacity: int,
                          grid_width: int):
    """`expand_elements`'s plain version: `decode_slots_plain` over
    `expand_rows_plain`."""
    _check_elements(cols, cum)
    return decode_slots_plain(*expand_rows_plain(cols, cum, capacity), grid_width)


def _launch_elements(name: str, cols: torch.Tensor, cum: torch.Tensor, capacity: int,
                     grid_width: int):
    dev = _build.card_device(cols, cum)
    _check_elements(cols, cum)
    cols, cum = cols.contiguous(), cum.contiguous()
    tile, depth, index = (torch.empty(capacity, dtype=torch.int64, device=dev) for _ in range(3))
    count = torch.empty((), dtype=torch.int64, device=dev)
    nblocks = -(-(cols.shape[1] + capacity) // ITEMS_PER_BLOCK)
    part = torch.empty(nblocks + 1, dtype=torch.int64, device=dev)
    _build.launch(name, "vk3d_expand_elements", cols.data_ptr(), cum.data_ptr(), cols.shape[1],
                  capacity, grid_width, part.data_ptr(), nblocks, tile.data_ptr(),
                  depth.data_ptr(), index.data_ptr(), count.data_ptr(), device=dev)
    return tile, depth, index, count


def expand_elements(cols: torch.Tensor, cum: torch.Tensor, capacity: int, grid_width: int, *,
                    streamed: bool = False):
    """keygen's expansion: K7's rows expanded over `capacity` slots and
    decoded into the sort elements in the same launch.

    Args:
      cols: [6, N] int32 rows (`Projection.cols`: id, offset, max(w, 1),
        min_x, min_y, the depth key's bits).
      cum: [N] int64 inclusive scan of the counts (`Projection.cum`).
      capacity: slot capacity E.
      grid_width: tiles a row of the tile grid.
      streamed: K1' (under the depth prefilter), counted as
        "expand_rows_streamed"; else K1, counted as "expand_rows".

    Returns (tile, depth, index, count): [E] int64 each, SENTINEL past
    min(total, E), and the [] int64 count min(total, E).  CPU tensors run
    `expand_elements_plain`.
    """
    if _build.on_card(cols, cum):
        return _launch_elements("expand_rows_streamed" if streamed else "expand_rows", cols, cum,
                                capacity, grid_width)
    return expand_elements_plain(cols, cum, capacity, grid_width)
