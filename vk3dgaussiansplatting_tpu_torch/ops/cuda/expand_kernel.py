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

Each wrapper launches the CUDA kernel for CUDA tensors and runs
`expand_rows_plain` for CPU tensors (`_build.on_card`); it never falls back
from one to the other.  `_build.LAUNCHES` counts K1's launches as
"expand_rows" and K1''s as "expand_rows_streamed".
"""

from __future__ import annotations

import torch

from . import _build

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
    """K1', keygen's expansion under the depth prefilter: `expand_rows`'s
    arguments and result, counted as "expand_rows_streamed"."""
    if _build.on_card(cols, cum):
        return _launch("expand_rows_streamed", cols, cum, capacity)
    return expand_rows_plain(cols, cum, capacity)
