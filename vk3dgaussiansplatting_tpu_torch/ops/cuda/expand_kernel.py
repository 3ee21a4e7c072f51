"""Monotone fixed-capacity expansion (K1) — wrapper of csrc/expand.cu.

Replaces vk3dgaussiansplatting_tpu/ops/pallas/expand_kernel.py:expand_rows.
`expand_rows` launches the CUDA kernel for CUDA tensors and runs
`expand_rows_plain` for CPU tensors; it never falls back from one to the
other.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0
MAX_COLS = 7


def _check(cols: torch.Tensor, counts: torch.Tensor) -> None:
    if cols.dim() != 2 or cols.dtype != torch.int32:
        raise ValueError(f"cols must be [C, N] int32, got {tuple(cols.shape)} {cols.dtype}")
    if not 1 <= cols.shape[0] <= MAX_COLS:
        raise ValueError(f"1..{MAX_COLS} columns supported, got {cols.shape[0]}")
    if counts.dim() != 1 or counts.shape[0] != cols.shape[1]:
        raise ValueError("counts must be [N] matching cols")
    if counts.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"counts must be int32 or int64, got {counts.dtype}")
    if counts.device != cols.device:
        raise ValueError("cols and counts must be on one device")


def expand_rows_plain(cols: torch.Tensor, counts: torch.Tensor, capacity: int):
    """`repeat_interleave` over the columns, truncated or zero-padded to
    `capacity` slots.  Returns ([C, capacity] int32, total [] int64)."""
    _check(cols, counts)
    counts = counts.to(torch.int64)
    total = counts.sum()
    rep = torch.repeat_interleave(cols, counts, dim=1)[:, :capacity]
    out = torch.zeros((cols.shape[0], capacity), dtype=torch.int32, device=cols.device)
    out[:, : rep.shape[1]] = rep
    return out, total


def expand_rows(cols: torch.Tensor, counts: torch.Tensor, capacity: int):
    """Expand ≤7 int32 columns of N rows by `counts` into `capacity` slots.

    Args:
      cols: [C, N] int32, one row per column of the packed source rows.
      counts: [N] int32/int64 per-row element counts (0 for culled rows).
      capacity: slot capacity E.

    Returns (out, total): [C, E] int32 with out[:, j] the row covering slot j
    (zeros past min(total, E)), and the [] int64 unclamped total.
    """
    global LAUNCHES
    _check(cols, counts)
    if cols.device.type == "cpu":
        return expand_rows_plain(cols, counts, capacity)
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    cols = cols.contiguous()
    cum = torch.cumsum(counts, 0, dtype=torch.int64)
    total = cum[-1] if cum.numel() else torch.zeros((), dtype=torch.int64, device=cols.device)
    out = torch.empty((cols.shape[0], capacity), dtype=torch.int32, device=cols.device)
    lib = _build.load_library()
    err = lib.vk3d_expand_rows(
        cols.data_ptr(),
        cols.shape[0],
        cum.data_ptr(),
        cols.shape[1],
        capacity,
        out.data_ptr(),
        cols.device.index,
        torch.cuda.current_stream(cols.device).cuda_stream,
    )
    _build.check_launch(err, "expand_rows")
    LAUNCHES += 1
    return out, total
