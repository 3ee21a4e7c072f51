"""Tiled front-to-back blend (K2) — wrapper of csrc/blend.cu.

Replaces vk3dgaussiansplatting_tpu/ops/pallas/blend_kernel.py:
blend_tiles_pallas and its feature table, `pack_feature_table`.  The kernel
gathers each element's row from the per-gaussian [N, 10] table itself, so
there is no [E, 16] sorted-order feature array as on the TPU.

`blend_rows` launches the CUDA kernel for CUDA tensors and runs
ops/blend.py:blend_rows_plain for CPU tensors; it never falls back from one
to the other.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from ...core.config import RenderConfig
from .. import blend as blend_ops
from ..keygen import GaussianFrameData, SortElements
from . import _build

LAUNCHES = 0


def pack_feature_table(frame: GaussianFrameData) -> torch.Tensor:
    """Per-gaussian blend-feature rows [N, 10] float32:
    [gx, gy, a', b', c', 0, r, g, b, galpha].

    The inverse covariance is pre-scaled (a' = -a/2, b' = -b, c' = -c/2) so
    f = a'dx^2 + c'dy^2 + b'dxdy directly; scaling by powers of two is exact,
    so this equals the GLSL -0.5(a dx^2 + c dy^2) - b dx dy
    (RenderGaussians.comp:117-124) bit for bit."""
    scale = torch.tensor([-0.5, -1.0, -0.5], device=frame.cov_inv.device)
    zeros = torch.zeros_like(frame.screen_pos[:, :1])
    return torch.cat(
        [frame.screen_pos, frame.cov_inv * scale, zeros, frame.color_alpha], dim=-1
    ).contiguous()


def _check(table, index, ranges, config: RenderConfig):
    if table.dim() != 2 or table.shape[1] != blend_ops.NUM_TABLE_COLS or table.dtype != torch.float32:
        raise ValueError(f"table must be [N, 10] float32, got {tuple(table.shape)} {table.dtype}")
    if index.dim() != 1 or index.dtype != torch.int64:
        raise ValueError(f"index must be [E] int64, got {tuple(index.shape)} {index.dtype}")
    if tuple(ranges.shape) != (config.num_tiles, 2) or ranges.dtype != torch.int64:
        raise ValueError(
            f"ranges must be [{config.num_tiles}, 2] int64, got "
            f"{tuple(ranges.shape)} {ranges.dtype}"
        )
    if config.tile_size != 16:
        raise ValueError("the blend kernel is built for 16x16 tiles")
    if not (table.device == index.device == ranges.device):
        raise ValueError("table, index and ranges must be on one device")


def blend_rows(
    table: torch.Tensor, index: torch.Tensor, ranges: torch.Tensor, config: RenderConfig
) -> torch.Tensor:
    """Blend every tile; returns float32 [H, W, 3] in [0, 1].

    table: [N, 10] float32 (pack_feature_table); index: [E] int64 sorted
    gaussian ids (SENTINEL if dead); ranges: [num_tiles, 2] int64."""
    global LAUNCHES
    _check(table, index, ranges, config)
    if table.device.type == "cpu":
        return blend_ops.blend_rows_plain(table, index, ranges, config)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    table, index, ranges = table.contiguous(), index.contiguous(), ranges.contiguous()
    out = torch.empty((config.height, config.width, 3), dtype=torch.float32, device=table.device)
    lib = _build.load_library()
    err = lib.vk3d_blend_tiles(
        table.data_ptr(),
        index.data_ptr(),
        ranges.data_ptr(),
        config.num_tiles,
        config.grid_width,
        config.width,
        config.height,
        config.alpha_cutoff,
        config.transmittance_stop,
        out.data_ptr(),
        table.device.index,
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _build.check_launch(err, "blend_tiles")
    LAUNCHES += 1
    return out


def blend_tiles(
    elements: SortElements,
    ranges: torch.Tensor,
    frame: GaussianFrameData,
    config: RenderConfig,
) -> torch.Tensor:
    """Blend all tiles of a sorted frame (blend_tiles_pallas's signature)."""
    return blend_rows(pack_feature_table(frame), elements.index, ranges, config)
