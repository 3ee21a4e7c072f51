"""Tiled front-to-back blends (K2, K3, K4) — wrappers of csrc/blend.cu,
csrc/blend_flat.cu and csrc/blend_strip.cu.

K2 `blend_tiles` replaces vk3dgaussiansplatting_tpu/ops/pallas/
blend_kernel.py:blend_tiles_pallas together with the feature build inside
it.  K3 `blend_flat` replaces blend_flat_core / blend_tiles_pallas_flat,
the capped path's blend with its per-pixel transmittance output; K4
`blend_strip` replaces blend_strip_colors_pallas, the distributed frame's
carry-aware strip blend.  All three stage their rows through
csrc/blend_rows.cuh.  K2 and K3 read each element's row of the frame data
by id, so neither the uncapped nor the capped frame builds a feature
table; K4 reads the `pack_feature_table` rows that the exchange routed in
sorted order (or gathers them by id), so there is no [16, E] sorted-order
feature array as on the TPU.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version in ops/blend.py (blend_rows_plain, blend_flat_plain,
blend_strip_plain) for CPU tensors; none falls back from one to the other.
`LAUNCHES` (K2), `FLAT_LAUNCHES` (K3) and `STRIP_LAUNCHES` (K4) count
kernel launches.
"""

from __future__ import annotations

import torch

from ...core.config import RenderConfig
from .. import blend as blend_ops
from ..keygen import GaussianFrameData, SortElements
from . import _build

LAUNCHES = 0
FLAT_LAUNCHES = 0
STRIP_LAUNCHES = 0


def pack_feature_table(frame: GaussianFrameData) -> torch.Tensor:
    """Per-gaussian blend-feature rows [N, 10] float32:
    [gx, gy, a', b', c', 0, r, g, b, galpha].

    The inverse covariance is pre-scaled (a' = -a/2, b' = -b, c' = -c/2) so
    f = a'dx^2 + c'dy^2 + b'dxdy directly; scaling by powers of two is exact,
    so this equals the GLSL -0.5(a dx^2 + c dy^2) - b dx dy
    (RenderGaussians.comp:117-124) bit for bit."""
    ci = frame.cov_inv
    # Scalar multiplies: a scale vector made on the device would cost a
    # host-synchronising copy per frame.
    cov_scaled = torch.stack([ci[:, 0] * -0.5, ci[:, 1] * -1.0, ci[:, 2] * -0.5], dim=-1)
    zeros = torch.zeros_like(frame.screen_pos[:, :1])
    return torch.cat(
        [frame.screen_pos, cov_scaled, zeros, frame.color_alpha], dim=-1
    ).contiguous()


def _check_index_ranges(index, ranges, config: RenderConfig) -> None:
    if index.dim() != 1 or index.dtype != torch.int64:
        raise ValueError(f"index must be [E] int64, got {tuple(index.shape)} {index.dtype}")
    if tuple(ranges.shape) != (config.num_tiles, 2) or ranges.dtype != torch.int64:
        raise ValueError(
            f"ranges must be [{config.num_tiles}, 2] int64, got "
            f"{tuple(ranges.shape)} {ranges.dtype}"
        )
    if config.tile_size != 16:
        raise ValueError("the blend kernel is built for 16x16 tiles")


# The frame tensors K2 and K3 read, with their widths and the alignment
# their vector copies need (bytes).
_FRAME_ROWS = (("screen_pos", 2, 8), ("cov_inv", 3, 4), ("color_alpha", 4, 16))


def _check_frame(frame: GaussianFrameData, index, ranges, config: RenderConfig) -> None:
    n = frame.screen_pos.shape[0]
    for name, width, _align in _FRAME_ROWS:
        x = getattr(frame, name)
        if tuple(x.shape) != (n, width) or x.dtype != torch.float32:
            raise ValueError(f"frame.{name} must be [{n}, {width}] float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"frame.{name} must be contiguous (the kernel reads its rows)")
    _check_index_ranges(index, ranges, config)
    devices = {getattr(frame, name).device for name, _w, _a in _FRAME_ROWS}
    if len(devices | {index.device, ranges.device}) != 1:
        raise ValueError("the frame tensors, index and ranges must be on one device")


def _frame_pointers(frame: GaussianFrameData) -> list[int]:
    """The frame tensors' device pointers, in _FRAME_ROWS order; raises if
    one is not aligned for the kernels' vector copies."""
    ptrs = []
    for name, _width, align in _FRAME_ROWS:
        ptr = getattr(frame, name).data_ptr()
        if ptr % align:
            raise ValueError(f"frame.{name} must be {align}-byte aligned")
        ptrs.append(ptr)
    return ptrs


def blend_tiles(
    elements: SortElements,
    ranges: torch.Tensor,
    frame: GaussianFrameData,
    config: RenderConfig,
) -> torch.Tensor:
    """K2: blend all tiles of a sorted frame (blend_tiles_pallas's
    signature); returns float32 [H, W, 3] in [0, 1].

    The kernel reads frame.screen_pos [N, 2], frame.cov_inv [N, 3] and
    frame.color_alpha [N, 4] (contiguous float32) by the sorted gaussian ids
    elements.index [E] int64 (SENTINEL if dead); ranges: [num_tiles, 2]
    int64.  On CPU tensors: blend_rows_plain on pack_feature_table(frame)."""
    global LAUNCHES
    _check_frame(frame, elements.index, ranges, config)
    device = frame.screen_pos.device
    if device.type == "cpu":
        return blend_ops.blend_rows_plain(pack_feature_table(frame), elements.index, ranges, config)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    ptrs = _frame_pointers(frame)
    index, ranges = elements.index.contiguous(), ranges.contiguous()
    out = torch.empty((config.height, config.width, 3), dtype=torch.float32, device=device)
    err = _build.load_library().vk3d_blend_tiles(
        *ptrs,
        index.data_ptr(),
        ranges.data_ptr(),
        config.num_tiles,
        config.grid_width,
        config.width,
        config.height,
        config.alpha_cutoff,
        config.transmittance_stop,
        out.data_ptr(),
        device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(err, "blend_tiles")
    LAUNCHES += 1
    return out


def blend_flat(
    frame: GaussianFrameData,
    index: torch.Tensor,
    ranges: torch.Tensor,
    config: RenderConfig,
    *,
    cap: int = 0,
    with_t: bool = False,
):
    """K3: blend every tile's [start, end) of `index` with the TPU flat
    kernel's transmittance semantics (ops/blend.py:blend_flat_plain).

    The kernel reads frame.screen_pos [N, 2], frame.cov_inv [N, 3] and
    frame.color_alpha [N, 4] (contiguous float32, as K2) by the gaussian ids
    index [E] int64 (SENTINEL, and slots >= E, are dead); ranges:
    [num_tiles, 2] int64; cap > 0 cuts each range to its first `cap`
    elements.  Returns the [H, W, 3] float32 image in [0, 1], and with
    `with_t` also the per-pixel outgoing transmittance [num_tiles, 256]
    float32; both equal the plain version's bit for bit.  On CPU tensors:
    blend_flat_plain on pack_feature_table(frame)."""
    global FLAT_LAUNCHES
    _check_frame(frame, index, ranges, config)
    if config.blend_batch_k <= 0 or config.blend_batch_k % blend_ops.ALIGN_K:
        raise ValueError(f"blend_batch_k must be a positive multiple of {blend_ops.ALIGN_K}")
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    device = frame.screen_pos.device
    if device.type == "cpu":
        return blend_ops.blend_flat_plain(pack_feature_table(frame), index, ranges, config,
                                          cap=cap, with_t=with_t)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    ptrs = _frame_pointers(frame)
    index, ranges = index.contiguous(), ranges.contiguous()
    out = torch.empty((config.height, config.width, 3), dtype=torch.float32, device=device)
    t_out = (
        torch.empty((config.num_tiles, config.tile_size**2), dtype=torch.float32, device=device)
        if with_t else None
    )
    err = _build.load_library().vk3d_blend_flat(
        *ptrs,
        index.data_ptr(),
        index.shape[0],
        ranges.data_ptr(),
        config.num_tiles,
        cap,
        config.blend_batch_k,
        config.grid_width,
        config.width,
        config.height,
        config.alpha_cutoff,
        config.transmittance_stop,
        out.data_ptr(),
        t_out.data_ptr() if with_t else None,
        device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check_launch(err, "blend_flat")
    FLAT_LAUNCHES += 1
    return (out, t_out) if with_t else out


def blend_tiles_flat(
    elements: SortElements,
    ranges: torch.Tensor,
    frame: GaussianFrameData,
    config: RenderConfig,
    *,
    cap: int = 0,
    with_t: bool = False,
):
    """K3 over a sorted frame (blend_tiles_pallas_flat's signature)."""
    return blend_flat(frame, elements.index, ranges, config, cap=cap, with_t=with_t)


def blend_strip(
    rows: torch.Tensor,
    index: torch.Tensor,
    ranges: torch.Tensor,
    config: RenderConfig,
    *,
    tile_base: int,
    carry_color: torch.Tensor,
    carry_logt: torch.Tensor,
    gather: bool = False,
):
    """K4: blend strip tiles [tile_base, tile_base + T_s) from the incoming
    (colour, log T) carry (ops/blend.py:blend_strip_plain has the semantics).

    rows: [E, 10] float32 rows in slot order, or with `gather` the [N, 10]
    per-gaussian table read by `index` (pack_feature_table's columns,
    8-byte aligned on the card); index: [E] int64 gaussian ids (SENTINEL,
    and slots >= E, are dead); ranges: [T_s, 2] int64 into the slots;
    carry_color: [T_s, 256, 3] float32; carry_logt: [T_s, 256] float32.
    Returns (colors [T_s, 256, 3] unclipped, logt_end [T_s, 256]).

    The kernel stops each pixel once its T < transmittance_stop, where the
    plain version keeps multiplying T to the end of the batch.  So the
    colours equal the plain version's bit for bit, and log T does wherever
    the plain T >= transmittance_stop; elsewhere both T are below the stop
    (their logs at most float32 log(transmittance_stop)), which is all the
    next phase's carry reads."""
    global STRIP_LAUNCHES
    t_s = ranges.shape[0]
    p = config.tile_size**2
    if rows.dim() != 2 or rows.shape[1] != blend_ops.NUM_TABLE_COLS or rows.dtype != torch.float32:
        raise ValueError(f"rows must be [E, 10] float32, got {tuple(rows.shape)} {rows.dtype}")
    if index.dim() != 1 or index.dtype != torch.int64:
        raise ValueError(f"index must be [E] int64, got {tuple(index.shape)} {index.dtype}")
    if not gather and rows.shape[0] != index.shape[0]:
        raise ValueError(f"{rows.shape[0]} rows for {index.shape[0]} slots")
    if ranges.dim() != 2 or ranges.shape[1] != 2 or ranges.dtype != torch.int64:
        raise ValueError(f"ranges must be [T_s, 2] int64, got {tuple(ranges.shape)} {ranges.dtype}")
    if tuple(carry_color.shape) != (t_s, p, 3) or tuple(carry_logt.shape) != (t_s, p):
        raise ValueError(
            f"carries must be [{t_s}, {p}, 3] and [{t_s}, {p}], got "
            f"{tuple(carry_color.shape)} and {tuple(carry_logt.shape)}"
        )
    if carry_color.dtype != torch.float32 or carry_logt.dtype != torch.float32:
        raise ValueError("carries must be float32")
    if not (0 <= tile_base and tile_base + t_s <= config.num_tiles):
        raise ValueError(f"strip [{tile_base}, {tile_base + t_s}) is outside the "
                         f"{config.num_tiles} tiles")
    if config.tile_size != 16:
        raise ValueError("the blend kernel is built for 16x16 tiles")
    if config.blend_batch_k <= 0 or config.blend_batch_k % blend_ops.ALIGN_K:
        raise ValueError(f"blend_batch_k must be a positive multiple of {blend_ops.ALIGN_K}")
    if len({x.device for x in (rows, index, ranges, carry_color, carry_logt)}) != 1:
        raise ValueError("rows, index, ranges and carries must be on one device")
    kw = dict(tile_base=tile_base, carry_color=carry_color, carry_logt=carry_logt, gather=gather)
    if rows.device.type == "cpu":
        return blend_ops.blend_strip_plain(rows, index, ranges, config, **kw)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    rows, index, ranges = rows.contiguous(), index.contiguous(), ranges.contiguous()
    if rows.data_ptr() % 8:
        raise ValueError("rows must be 8-byte aligned (the kernel copies 8-byte pieces)")
    carry_color, carry_logt = carry_color.contiguous(), carry_logt.contiguous()
    colors = torch.empty_like(carry_color)
    logt = torch.empty_like(carry_logt)
    err = _build.load_library().vk3d_blend_strip(
        rows.data_ptr(),
        index.data_ptr(),
        index.shape[0],
        int(gather),
        ranges.data_ptr(),
        t_s,
        tile_base,
        config.grid_width,
        config.alpha_cutoff,
        config.transmittance_stop,
        carry_color.data_ptr(),
        carry_logt.data_ptr(),
        colors.data_ptr(),
        logt.data_ptr(),
        rows.device.index,
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    _build.check_launch(err, "blend_strip")
    STRIP_LAUNCHES += 1
    return colors, logt


def strip_mismatch(got, want, t_stop: float) -> str | None:
    """How K4's (colors, logt) `got` breaks its contract with the plain
    version's `want` (blend_strip's docstring), or None: colours equal bit
    for bit; log T equal where the plain T >= t_stop, both T below t_stop
    elsewhere.  In log space, against the float32 log(t_stop): equal where
    the plain log T is above it, at or below it elsewhere (a T just under
    the stop can round to it)."""
    (colors, logt), (want_colors, want_logt) = got, want
    if not torch.equal(colors, want_colors):
        d = (colors - want_colors).abs().nan_to_num(posinf=float("inf"))
        return (f"colour differs from its plain version at {int((colors != want_colors).sum())} "
                f"values, max |Δ| {float(d.max())}")
    log_stop = want_logt.new_tensor(t_stop).log()
    alive = want_logt > log_stop
    if not torch.equal(logt[alive], want_logt[alive]):
        return f"log T differs where T >= the stop at {int((logt != want_logt)[alive].sum())} pixels"
    if not bool((logt[~alive] <= log_stop).all()):
        return "log T is above log(stop) where the plain T is below the stop"
    return None
