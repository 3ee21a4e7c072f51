"""Morton / Z-order curve encoding (reference: SMath::encodeZorderCurve,
Engine/SMath.h:10-34), host-side numpy, run once at scene load."""

from __future__ import annotations

import numpy as np


def _part_by_2(x: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each element to every third bit."""
    x = x.astype(np.uint32) & np.uint32(0x000003FF)
    x = (x ^ (x << 16)) & np.uint32(0xFF0000FF)
    x = (x ^ (x << 8)) & np.uint32(0x0300F00F)
    x = (x ^ (x << 4)) & np.uint32(0x030C30C3)
    x = (x ^ (x << 2)) & np.uint32(0x09249249)
    return x


def encode_zorder(pos: np.ndarray) -> np.ndarray:
    """Integer [N,3] grid positions (each < 1024) -> 30-bit Morton keys,
    key = (part(z) << 2) + (part(y) << 1) + part(x) (SMath.h:24-34)."""
    pos = np.asarray(pos)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"expected [N,3] positions, got {pos.shape}")
    if (pos < 0).any() or (pos >= 1024).any():
        raise ValueError("morton components must be in [0, 1024)")
    return (
        (_part_by_2(pos[:, 2]) << 2)
        + (_part_by_2(pos[:, 1]) << 1)
        + _part_by_2(pos[:, 0])
    )


def morton_order(positions: np.ndarray) -> np.ndarray:
    """Permutation sorting gaussians along the Z-order curve
    (ResourceManager.cpp:283-297): min/max-normalized float32 positions on a
    1023^3 grid, truncating float->uint conversion, stable argsort."""
    positions = np.asarray(positions, dtype=np.float32)
    min_pos = positions.min(axis=0)
    max_pos = positions.max(axis=0)
    delta = max_pos - min_pos
    delta = np.where(delta == 0.0, np.float32(1.0), delta)
    morton_size = np.float32((1 << 10) - 1)
    grid = ((positions - min_pos) / delta * morton_size).astype(np.uint32)
    grid = np.minimum(grid, np.uint32(1023))
    return np.argsort(encode_zorder(grid), kind="stable")
