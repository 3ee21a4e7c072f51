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
table; K4 reads the `pack_feature_table` rows (ops/blend.py) that the
exchange routed in sorted order (or gathers them by id), so there is no
[16, E] sorted-order feature array as on the TPU.

The wrappers take CUDA tensors only and raise for any other device: the
blends' entry points in ops/blend.py run the plain versions
(blend_rows_plain, blend_flat_plain, blend_strip_plain) for CPU tensors,
and check CPU input with this module's `check_frame`, `check_flat` and
`check_strip`.  `_build.LAUNCHES` counts the launches under the wrappers'
names.
"""

from __future__ import annotations

import torch

from ...core.config import RenderConfig
from . import _build

# Columns of the per-gaussian feature table (ops/blend.py
# pack_feature_table): gx, gy, a' = -a/2, b' = -b, c' = -c/2, 0, r, g, b,
# galpha.
NUM_TABLE_COLS = 10
# Batch starts of the JAX flat blend (blend_kernel.py:496): each tile's
# first batch begins at its range start rounded down to this alignment.
ALIGN_K = 128


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


def check_frame(frame, index, ranges, config: RenderConfig) -> None:
    """Raise unless K2 can read `frame` (a GaussianFrameData), `index` and
    `ranges` row by row."""
    n = frame.screen_pos.shape[0]
    for name, width, _align in _FRAME_ROWS:
        x = getattr(frame, name)
        if tuple(x.shape) != (n, width) or x.dtype != torch.float32:
            raise ValueError(f"frame.{name} must be [{n}, {width}] float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"frame.{name} must be contiguous (the kernel reads its rows)")
    _check_index_ranges(index, ranges, config)


def check_flat(frame, index, ranges, config: RenderConfig, cap: int) -> None:
    """`check_frame`, and K3's batch and cap."""
    check_frame(frame, index, ranges, config)
    _check_batch_k(config)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")


def _check_batch_k(config: RenderConfig) -> None:
    if config.blend_batch_k <= 0 or config.blend_batch_k % ALIGN_K:
        raise ValueError(f"blend_batch_k must be a positive multiple of {ALIGN_K}")


def _frame_device(frame, index, ranges) -> torch.device:
    return _build.card_device(*(getattr(frame, name) for name, _w, _a in _FRAME_ROWS), index,
                              ranges)


def _frame_pointers(frame) -> list[int]:
    """The frame tensors' device pointers, in _FRAME_ROWS order; raises if
    one is not aligned for the kernels' vector copies."""
    ptrs = []
    for name, _width, align in _FRAME_ROWS:
        ptr = getattr(frame, name).data_ptr()
        if ptr % align:
            raise ValueError(f"frame.{name} must be {align}-byte aligned")
        ptrs.append(ptr)
    return ptrs


def blend_tiles(frame, index: torch.Tensor, ranges: torch.Tensor,
                config: RenderConfig) -> torch.Tensor:
    """K2 (ops/blend.py:blend_tiles has the arguments); returns float32
    [H, W, 3] in [0, 1]."""
    device = _frame_device(frame, index, ranges)
    check_frame(frame, index, ranges, config)
    ptrs = _frame_pointers(frame)
    index, ranges = index.contiguous(), ranges.contiguous()
    out = torch.empty((config.height, config.width, 3), dtype=torch.float32, device=device)
    _build.launch("blend_tiles", "vk3d_blend_tiles", *ptrs, index.data_ptr(), ranges.data_ptr(),
                  config.num_tiles, config.grid_width, config.width, config.height,
                  config.alpha_cutoff, config.transmittance_stop, out.data_ptr(), device=device)
    return out


def blend_flat(frame, index: torch.Tensor, ranges: torch.Tensor, config: RenderConfig, *,
               cap: int = 0, with_t: bool = False):
    """K3 (ops/blend.py:blend_flat has the arguments): the image, and with
    `with_t` the per-pixel outgoing transmittance, both equal to
    blend_flat_plain's bit for bit."""
    device = _frame_device(frame, index, ranges)
    check_flat(frame, index, ranges, config, cap)
    ptrs = _frame_pointers(frame)
    index, ranges = index.contiguous(), ranges.contiguous()
    out = torch.empty((config.height, config.width, 3), dtype=torch.float32, device=device)
    t_out = (
        torch.empty((config.num_tiles, config.tile_size**2), dtype=torch.float32, device=device)
        if with_t else None
    )
    _build.launch("blend_flat", "vk3d_blend_flat", *ptrs, index.data_ptr(), index.shape[0],
                  ranges.data_ptr(), config.num_tiles, cap, config.blend_batch_k,
                  config.grid_width, config.width, config.height, config.alpha_cutoff,
                  config.transmittance_stop, out.data_ptr(),
                  t_out.data_ptr() if with_t else None, device=device)
    return (out, t_out) if with_t else out


def check_strip(rows, index, ranges, config: RenderConfig, *, tile_base: int, carry_color,
                carry_logt, gather: bool) -> None:
    """Raise unless K4 can take these arguments (ops/blend.py:blend_strip)."""
    t_s = ranges.shape[0]
    p = config.tile_size**2
    if rows.dim() != 2 or rows.shape[1] != NUM_TABLE_COLS or rows.dtype != torch.float32:
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
    _check_batch_k(config)


def blend_strip(rows, index, ranges, config: RenderConfig, *, tile_base: int, carry_color,
                carry_logt, gather: bool = False):
    """K4 (ops/blend.py:blend_strip has the arguments): (colors [T_s, 256,
    3] unclipped, logt_end [T_s, 256]).

    The kernel stops each pixel once its T < transmittance_stop, where the
    plain version keeps multiplying T to the end of the batch.  So the
    colours equal the plain version's bit for bit, and log T does wherever
    the plain T >= transmittance_stop; elsewhere both T are below the stop
    (their logs at most float32 log(transmittance_stop)), which is all the
    next phase's carry reads."""
    device = _build.card_device(rows, index, ranges, carry_color, carry_logt)
    check_strip(rows, index, ranges, config, tile_base=tile_base, carry_color=carry_color,
                carry_logt=carry_logt, gather=gather)
    rows, index, ranges = rows.contiguous(), index.contiguous(), ranges.contiguous()
    if rows.data_ptr() % 8:
        raise ValueError("rows must be 8-byte aligned (the kernel copies 8-byte pieces)")
    carry_color, carry_logt = carry_color.contiguous(), carry_logt.contiguous()
    colors = torch.empty_like(carry_color)
    logt = torch.empty_like(carry_logt)
    _build.launch("blend_strip", "vk3d_blend_strip", rows.data_ptr(), index.data_ptr(),
                  index.shape[0], int(gather), ranges.data_ptr(), ranges.shape[0], tile_base,
                  config.grid_width, config.alpha_cutoff, config.transmittance_stop,
                  carry_color.data_ptr(), carry_logt.data_ptr(), colors.data_ptr(),
                  logt.data_ptr(), device=device)
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
