"""Synthetic scenes — the reference's procedural fixtures and the benchmark
stand-in cloud.

Port of `vk3dgaussiansplatting_tpu.scenes.synthetic`.  Every generator draws
the same numpy random stream, in the same order, as the JAX package's, so a
seed gives both packages the same table; the table is then wrapped as CPU
tensors.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.config import MAX_UINT32
from ..models.gaussians import NUM_SH_COEFFS, GaussianTable
from .scene import Scene


def simple_test_gaussians_table(seed: int = 0) -> GaussianTable:
    """16 gaussians in a row (SimpleTestGaussiansScene.cpp:14-29)."""
    rng = np.random.default_rng(seed)
    n = 16
    position = np.stack(
        [
            -8.0 + np.arange(n, dtype=np.float32),
            np.zeros(n, dtype=np.float32),
            np.full(n, -1.0, dtype=np.float32),
        ],
        axis=1,
    )
    scale = np.tile(np.array([[0.1, 0.2, 0.5]], dtype=np.float32), (n, 1))
    rot = np.tile(np.array([[1.0, 0.0, 0.0, 0.0]], dtype=np.float32), (n, 1))
    sh = np.zeros((n, NUM_SH_COEFFS, 3), dtype=np.float32)
    # rand() % 10000 / 10000 equivalent:
    sh[:, 0, :] = (rng.integers(0, 10000, size=(n, 3)) / 10000.0).astype(np.float32)
    opacity = np.ones(n, dtype=np.float32)
    return GaussianTable.from_numpy(position, scale, rot, sh, opacity)


def test_sort_table(seed: int = 1) -> GaussianTable:
    """192 gaussians at crafted depth-key spacings (TestSortScene.cpp:15-33):
    gaussian i sits at the depth whose quantized key is (i+1)*1024."""
    rng = np.random.default_rng(seed)
    n = 64 * 3
    i = np.arange(n, dtype=np.float64)
    key_depth = (i + 1.0) * 1024.0
    near, far = 0.1, 100.0
    z = (key_depth / MAX_UINT32 * (far - near) + near).astype(np.float32)
    position = np.stack(
        [
            ((-8.0 + i) * 0.01).astype(np.float32),
            np.zeros(n, dtype=np.float32),
            z,
        ],
        axis=1,
    )
    scale = np.full((n, 3), 0.02, dtype=np.float32)
    rot = np.tile(np.array([[1.0, 0.0, 0.0, 0.0]], dtype=np.float32), (n, 1))
    sh = np.zeros((n, NUM_SH_COEFFS, 3), dtype=np.float32)
    sh[:, 0, :] = (rng.integers(0, 10000, size=(n, 3)) / 10000.0).astype(np.float32)
    opacity = np.ones(n, dtype=np.float32)
    return GaussianTable.from_numpy(position, scale, rot, sh, opacity)


# Opacity distributions of the procedural cloud (logit mean, std):
#   capture     — bimodal with most mass near 1 like trained captures
#                 (median ~0.92), the benchmark default;
#   translucent — a cloud that never saturates, for A/B comparisons.
OPACITY_MODES = {
    "capture": (2.5, 1.5),
    "translucent": (1.0, 2.0),
}


def procedural_cloud_table(
    num_gaussians: int,
    *,
    seed: int = 42,
    extent: float = 6.0,
    scale_log_mean: float = -5.0,
    scale_log_std: float = 0.8,
    opacity_mode: str = "capture",
    sh_rest_std: float = 0.05,
    cluster_fraction: float = 0.5,
) -> GaussianTable:
    """Benchmark-scale random gaussian cloud: half near the origin
    (foreground), half over the full extent, log-normal scales, random
    orientations, rows in a seeded random order.  The benchmark calibrates a
    scale multiplier so the camera sees the reference row's element count."""
    opacity_logit_mean, opacity_logit_std = OPACITY_MODES[opacity_mode]
    rng = np.random.default_rng(seed)
    n = num_gaussians
    n_cluster = int(n * cluster_fraction)
    n_spread = n - n_cluster
    pos_cluster = rng.normal(0.0, extent * 0.15, size=(n_cluster, 3))
    pos_spread = rng.uniform(-extent, extent, size=(n_spread, 3))
    position = np.concatenate([pos_cluster, pos_spread]).astype(np.float32)

    scale = np.exp(rng.normal(scale_log_mean, scale_log_std, size=(n, 3))).astype(np.float32)

    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = q.astype(np.float32)

    opacity = 1.0 / (
        1.0 + np.exp(-rng.normal(opacity_logit_mean, opacity_logit_std, size=n))
    )

    sh = np.zeros((n, NUM_SH_COEFFS, 3), dtype=np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 1.5, size=(n, 3))
    sh[:, 1:, :] = rng.normal(0.0, sh_rest_std, size=(n, NUM_SH_COEFFS - 1, 3))

    perm = rng.permutation(n)
    return GaussianTable.from_numpy(
        position[perm], scale[perm], rot[perm], sh[perm], opacity.astype(np.float32)[perm]
    )


class SimpleTestGaussiansScene(Scene):
    """SimpleTestGaussiansScene.cpp: camera at (0,0,2) yaw=pi."""

    def init(self) -> None:
        self.camera.set_position((0.0, 0.0, 2.0))
        self.camera.set_rotation(math.pi, 0.0)
        self.add_gaussians(simple_test_gaussians_table())


class TestSortScene(Scene):
    """TestSortScene.cpp: camera at origin looking +z."""

    def init(self) -> None:
        self.camera.set_position((0.0, 0.0, 0.0))
        self.camera.set_rotation(0.0, 0.0)
        self.add_gaussians(test_sort_table())
