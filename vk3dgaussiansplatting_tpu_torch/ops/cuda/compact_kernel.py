"""Packed-layout copies (K5 `compact_slabs` and `compact_runs`, K6
`compact_segments`) — wrappers of csrc/compact.cu.

Replace vk3dgaussiansplatting_tpu/ops/pallas/compact_kernel.py:compact_runs
and :compact_segments.  The capped layout (ops/capped.py) copies each
tile's run of sorted gaussian ids into 128-aligned slabs with
`compact_slabs`, K5 redesigned for the card: each tile writes its own slab,
ids on its live lanes and SENTINEL elsewhere, so the layout's final ids come
out of one launch with no chunk map and no mask passes.  `compact_runs` is
the TPU function as it is (every lane, zero fill; no path runs it since
`compact_slabs`), and K6 the per-128-lane-chunk copy it replaced on the
TPU; both are kept because they are kernels of the JAX package.

Values are int64 (the port's sorted ids: uint32 values, SENTINEL included).
Source slots at or past E read 0, as the TPU wrappers' zero padding does.
Lanes no tile writes hold 0 in `compact_runs` here; on the TPU they hold
whatever the output buffer held, and callers mask them either way.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors; it never falls back from one to the other.
`SLABS_LAUNCHES`, `RUNS_LAUNCHES` and `SEGMENTS_LAUNCHES` count kernel
launches.
"""

from __future__ import annotations

import torch

from ...core.config import SENTINEL
from . import _build, expand_kernel

CHUNK = 128
SLABS_LAUNCHES = 0
RUNS_LAUNCHES = 0
SEGMENTS_LAUNCHES = 0


def _check_src(src: torch.Tensor, ep: int) -> None:
    if src.dim() != 1 or src.dtype != torch.int64:
        raise ValueError(f"src must be [E] int64, got {tuple(src.shape)} {src.dtype}")
    if ep < 0 or ep % CHUNK:
        raise ValueError(f"ep must be a non-negative multiple of {CHUNK}, got {ep}")


def _check_table(name: str, x: torch.Tensor, src: torch.Tensor, n: int | None = None) -> None:
    if x.dim() != 1 or x.dtype != torch.int64:
        raise ValueError(f"{name} must be 1-D int64, got {tuple(x.shape)} {x.dtype}")
    if n is not None and x.shape[0] != n:
        raise ValueError(f"{name} must have {n} entries, got {x.shape[0]}")
    if x.device != src.device:
        raise ValueError(f"{name} and src must be on one device")


def _padded(src: torch.Tensor, pad: int) -> torch.Tensor:
    """src zero-padded to a multiple of 128, plus `pad` (the TPU wrappers'
    source row)."""
    e = src.shape[0]
    return torch.cat([src, src.new_zeros(-(-e // CHUNK) * CHUNK - e + pad)])


def _runs_offsets(src, starts, sbases, ep: int, wmax: int):
    """The TPU wrapper's clipped offsets (compact_kernel.py:145-149)."""
    e_pad = -(-src.shape[0] // CHUNK) * CHUNK + wmax
    astarts = torch.clamp(torch.div(starts, CHUNK, rounding_mode="floor") * CHUNK, 0, e_pad - wmax)
    return astarts.contiguous(), torch.clamp(sbases, 0, ep).contiguous()


def compact_runs_plain(src, starts, sbases, ep: int, wmax: int) -> torch.Tensor:
    """The TPU kernel's stores, one tile after another: out[sbase_t : +wmax]
    = src[astart_t : +wmax] (zero past E), later tiles overwriting."""
    astarts, sb = _runs_offsets(src, starts, sbases, ep, wmax)
    src_pad = _padded(src, wmax)
    out = src.new_zeros(ep + wmax)
    for a, b in zip(astarts.tolist(), sb.tolist()):
        out[b : b + wmax] = src_pad[a : a + wmax]
    return out[:ep]


def compact_runs(src, starts, sbases, ep: int, wmax: int) -> torch.Tensor:
    """Per-run alignment-preserving compaction: for every tile t, with
    off_t = starts[t] mod 128, out[sbases[t] + off_t + i] = src[starts[t] + i]
    for i < wmax - off_t.

    Args:
      src: [E] int64 source values (sorted element order).
      starts: [T] int64 first source slot per tile.
      sbases: [T] int64 128-aligned slab bases, non-decreasing, with
        sbases[t+1] - sbases[t] <= wmax.
      ep: packed capacity, a multiple of 128; wmax: the per-tile window, a
        multiple of 128.

    Returns [ep] int64."""
    global RUNS_LAUNCHES
    _check_src(src, ep)
    _check_table("starts", starts, src)
    _check_table("sbases", sbases, src, starts.shape[0])
    if wmax <= 0 or wmax % CHUNK:
        raise ValueError(f"wmax must be a positive multiple of {CHUNK}, got {wmax}")
    if src.device.type == "cpu":
        return compact_runs_plain(src, starts, sbases, ep, wmax)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    astarts, sb = _runs_offsets(src, starts, sbases, ep, wmax)
    src = src.contiguous()
    out = torch.empty(ep, dtype=torch.int64, device=src.device)
    err = _build.load_library().vk3d_compact_runs(
        src.data_ptr(), src.shape[0], astarts.data_ptr(), sb.data_ptr(), sb.shape[0], ep, wmax,
        out.data_ptr(), src.device.index, torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check_launch(err, "compact_runs")
    RUNS_LAUNCHES += 1
    return out


def compact_slabs_plain(src, starts, sbase, slabw, off, counts, ep: int) -> torch.Tensor:
    """`compact_runs_plain` followed by the mask the capped layout applied
    before `compact_slabs`: the K1 chunk map (`expand_rows_plain` of each
    tile's (sbase / 128, count, off) over its slab's chunks) marks each
    chunk's live lanes, and a live lane must not hold SENTINEL."""
    wmax = max(CHUNK, int(slabw.max())) if slabw.numel() else CHUNK
    gid_raw = compact_runs_plain(src, starts, sbase, ep, wmax)
    nchunks = ep // CHUNK
    cols, _ = expand_kernel.expand_rows_plain(
        torch.stack([sbase // CHUNK, counts, off]).to(torch.int32), slabw // CHUNK, nchunks)
    cols = cols.to(torch.int64)
    chunk_local = (torch.arange(nchunks, device=src.device) - cols[0]) * CHUNK
    lo, hi = cols[2] - chunk_local, cols[2] + cols[1] - chunk_local
    lane = torch.arange(CHUNK, device=src.device)
    seg_live = ((lane >= lo[:, None]) & (lane < hi[:, None])).reshape(-1)
    live = seg_live & (gid_raw != SENTINEL)
    return torch.where(live, gid_raw, SENTINEL)


def compact_slabs(src, starts, sbase, slabw, off, counts, ep: int) -> torch.Tensor:
    """The capped layout's ids: for every tile t and i < counts[t],
    out[sbase[t] + off[t] + i] = src[starts[t] + i], and SENTINEL on every
    other lane of [0, ep); lanes at or past ep are dropped (an overflowing
    layout is clipped).

    Args:
      src: [E] int64 source values (sorted element order).
      starts: [T] int64 first source slot per tile, with off[t] =
        starts[t] mod 128.
      sbase: [T] int64 slab bases, the exclusive scan of `slabw`.
      slabw: [T] int64 slab widths, multiples of 128 with
        off[t] + counts[t] <= slabw[t].
      off, counts: [T] int64 each tile's lane offset and live length.
      ep: packed capacity, a multiple of 128.

    Returns [ep] int64."""
    global SLABS_LAUNCHES
    _check_src(src, ep)
    for name, x in (("starts", starts), ("sbase", sbase), ("slabw", slabw), ("off", off),
                    ("counts", counts)):
        _check_table(name, x, src, starts.shape[0])
    if src.device.type == "cpu":
        return compact_slabs_plain(src, starts, sbase, slabw, off, counts, ep)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    # The kernel clips the aligned starts itself and reads `starts` with its
    # stride (the capped layout passes a column of the ranges): the launch
    # is the wrapper's one device operation besides the output's allocation.
    tables = [x.contiguous() for x in (sbase, slabw, off, counts)]
    src = src.contiguous()
    out = torch.empty(ep, dtype=torch.int64, device=src.device)
    err = _build.load_library().vk3d_compact_slabs(
        src.data_ptr(), src.shape[0], starts.data_ptr(), starts.stride(0),
        *(x.data_ptr() for x in tables), starts.shape[0], ep, out.data_ptr(), src.device.index,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check_launch(err, "compact_slabs")
    SLABS_LAUNCHES += 1
    return out


def _segment_starts(src, src0):
    """The TPU wrapper's clip (compact_kernel.py:231)."""
    e_pad = -(-src.shape[0] // CHUNK) * CHUNK + 2 * CHUNK
    return torch.clamp(src0, 0, e_pad - 2 * CHUNK).contiguous()


def compact_segments_plain(src, src0, ep: int) -> torch.Tensor:
    """out[128 j + l] = src[clip(src0_j) + l] (zero past E)."""
    s0 = _segment_starts(src, src0)
    pos = s0[:, None] + torch.arange(CHUNK, device=src.device)
    return _padded(src, 2 * CHUNK)[pos.reshape(-1)]


def compact_segments(src, src0, ep: int) -> torch.Tensor:
    """Copy per-chunk 128-lane source windows into a packed [ep] array.

    src: [E] int64; src0: [ep // 128] int64 first source slot of each packed
    chunk (clipped in bounds here); ep: a multiple of 128.  Returns [ep]
    int64."""
    global SEGMENTS_LAUNCHES
    _check_src(src, ep)
    _check_table("src0", src0, src, ep // CHUNK)
    if src.device.type == "cpu":
        return compact_segments_plain(src, src0, ep)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    s0 = _segment_starts(src, src0)
    src = src.contiguous()
    out = torch.empty(ep, dtype=torch.int64, device=src.device)
    err = _build.load_library().vk3d_compact_segments(
        src.data_ptr(), src.shape[0], s0.data_ptr(), ep, out.data_ptr(), src.device.index,
        torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check_launch(err, "compact_segments")
    SEGMENTS_LAUNCHES += 1
    return out
