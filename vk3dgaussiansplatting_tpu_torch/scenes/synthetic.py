"""Synthetic scenes — the reference's procedural fixtures and the benchmark
stand-in clouds.

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


def procedural_surface_table(
    num_gaussians: int,
    *,
    seed: int = 42,
    extent: float = 6.0,
    num_surfaces: int = 400,
    scale_log_mean: float = -5.0,
    scale_log_std: float = 0.6,
    flatten: float = 0.12,
    sh_rest_std: float = 0.05,
) -> GaussianTable:
    """Surface-structured benchmark cloud: gaussians on random ellipsoidal
    surface patches (small normal jitter), each one's shortest axis along
    the surface normal, ~90% opaque surface (sigmoid(N(3.5, 1))) and ~10%
    haze (sigmoid(N(-1, 1))), rows in a seeded random order — the shape of
    a trained capture, which a uniform cloud does not have."""
    rng = np.random.default_rng(seed)
    n = num_gaussians

    surf = rng.integers(0, num_surfaces, size=n)
    centers = rng.uniform(-extent, extent, size=(num_surfaces, 3))
    radii = np.exp(rng.normal(-0.3, 0.7, size=(num_surfaces, 3))) * (extent * 0.25)
    # points on the unit sphere -> per-surface ellipsoid
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    jitter = 1.0 + rng.normal(0.0, 0.01, size=(n, 1))
    position = (centers[surf] + u * radii[surf] * jitter).astype(np.float32)

    # Shortest axis along the surface normal (u / radii^2, normalized): the
    # quaternion rotating +z to the normal, or a half turn about x where the
    # normal is ~ -z.
    normal = u / np.maximum(radii[surf] ** 2, 1e-6)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(np.broadcast_to(z, normal.shape), normal)
    w = 1.0 + normal[:, 2:3]
    q = np.concatenate([w, axis], axis=1)
    qn = np.linalg.norm(q, axis=1, keepdims=True)
    q = np.where(qn > 1e-6, q / np.maximum(qn, 1e-12), np.array([[0.0, 1.0, 0.0, 0.0]]))
    rot = q.astype(np.float32)

    scale = np.exp(rng.normal(scale_log_mean, scale_log_std, size=(n, 3))).astype(np.float32)
    scale[:, 2] *= np.float32(flatten)  # tangential disks

    haze = rng.random(n) < 0.1
    logits = np.where(haze, rng.normal(-1.0, 1.0, size=n), rng.normal(3.5, 1.0, size=n))
    opacity = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)

    sh = np.zeros((n, NUM_SH_COEFFS, 3), dtype=np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 1.5, size=(n, 3))
    sh[:, 1:, :] = rng.normal(0.0, sh_rest_std, size=(n, NUM_SH_COEFFS - 1, 3))

    perm = rng.permutation(n)
    return GaussianTable.from_numpy(
        position[perm], scale[perm], rot[perm], sh[perm], opacity[perm]
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


class ProceduralBenchScene(Scene):
    """Benchmark stand-in for the Garden/Train .ply scenes: a
    `procedural_cloud_table` of `num_gaussians`, camera at (0,0,2) yaw=pi."""

    def __init__(self, num_gaussians: int, aspect: float = 16.0 / 9.0, seed: int = 42):
        super().__init__(aspect)
        self.num_gaussians = num_gaussians
        self.seed = seed

    def init(self) -> None:
        self.camera.set_position((0.0, 0.0, 2.0))
        self.camera.set_rotation(math.pi, 0.0)
        self.add_gaussians(procedural_cloud_table(self.num_gaussians, seed=self.seed))
