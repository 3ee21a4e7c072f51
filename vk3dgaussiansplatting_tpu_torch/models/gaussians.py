"""Gaussian scene model — a structure-of-arrays table of tensors.

Port of `vk3dgaussiansplatting_tpu.models.gaussians`.  The reference keeps
an array of 352-byte `GaussianData` structs (ShaderStructs.h:59-70); here each
attribute is one contiguous `[N, ...]` float32 tensor, so every per-gaussian
pass is one elementwise map over the table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.morton import morton_order

NUM_SH_COEFFS = 16


@dataclasses.dataclass(frozen=True)
class GaussianTable:
    """SoA table of N gaussians, all float32 tensors on one device.

      position [N, 3] — world position, x/y negated at load
                (ResourceManager.cpp:231-236)
      scale    [N, 3] — exp-activated scales
      rot      [N, 4] — normalized, component-permuted quaternion
      sh       [N, 16, 3] — SH coefficients, coeff-major
      opacity  [N]    — sigmoid-activated opacity
    """

    position: torch.Tensor
    scale: torch.Tensor
    rot: torch.Tensor
    sh: torch.Tensor
    opacity: torch.Tensor

    @classmethod
    def from_numpy(cls, position, scale, rot, sh, opacity) -> "GaussianTable":
        """Build a CPU table from array-likes (copied to float32)."""

        def t(x):
            return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))

        return cls(t(position), t(scale), t(rot), t(sh), t(opacity))

    @property
    def num_gaussians(self) -> int:
        return self.position.shape[0]

    def __len__(self) -> int:
        return self.num_gaussians

    @property
    def device(self) -> torch.device:
        return self.position.device

    def to(self, device) -> "GaussianTable":
        return GaussianTable(
            *(
                getattr(self, f.name).to(device=device, dtype=torch.float32).contiguous()
                for f in dataclasses.fields(self)
            )
        )

    def to_numpy(self) -> dict:
        return {
            f.name: getattr(self, f.name).cpu().numpy()
            for f in dataclasses.fields(self)
        }

    def take(self, indices) -> "GaussianTable":
        """The rows `indices` (an int array or tensor), in that order."""
        idx = torch.as_tensor(indices, device=self.device)
        return GaussianTable(*(getattr(self, f.name)[idx] for f in dataclasses.fields(self)))

    def concat(self, other: "GaussianTable") -> "GaussianTable":
        return concat_tables([self, other])


def concat_tables(tables: list[GaussianTable]) -> GaussianTable:
    return GaussianTable(
        *(
            torch.cat([getattr(t, f.name) for t in tables])
            for f in dataclasses.fields(GaussianTable)
        )
    )


def from_raw_ply_columns(
    *,
    xyz: np.ndarray,
    scales: np.ndarray,
    rots: np.ndarray,
    opacities: np.ndarray,
    f_dc: np.ndarray,
    f_rest: np.ndarray,
    morton_sort: bool = True,
) -> GaussianTable:
    """The reference's load-time transforms on raw .ply columns
    (ResourceManager::loadGaussians, ResourceManager.cpp:227-297):

      - position = (-x, -y, z)
      - scale = exp(scale_i)
      - rot = normalize(r0..r3) permuted to (-r2, -r3, r0, -r1)
      - opacity = sigmoid(opacity)
      - sh[0] = f_dc; sh[1..15] = f_rest, channel-major
        (f_rest_{c + 15*ch} is coefficient c+1 of channel ch)
      - rows sorted along the Morton curve of the normalized positions.

    Computed in numpy float32 exactly as the JAX package does, so both give
    the same table for the same file.
    """
    n = xyz.shape[0]
    xyz = np.asarray(xyz, dtype=np.float32)
    position = np.stack([-xyz[:, 0], -xyz[:, 1], xyz[:, 2]], axis=1)
    scale = np.exp(np.asarray(scales, dtype=np.float32))

    rots = np.asarray(rots, dtype=np.float32)
    norm = np.sqrt((rots * rots).sum(axis=1, keepdims=True))
    rots = rots / norm
    rot = np.stack([-rots[:, 2], -rots[:, 3], rots[:, 0], -rots[:, 1]], axis=1)

    opacity = 1.0 / (1.0 + np.exp(-np.asarray(opacities, dtype=np.float32)))

    sh = np.zeros((n, NUM_SH_COEFFS, 3), dtype=np.float32)
    sh[:, 0, :] = np.asarray(f_dc, dtype=np.float32)
    f_rest = np.asarray(f_rest, dtype=np.float32)
    if f_rest.size:
        num_rest = NUM_SH_COEFFS - 1
        for ch in range(3):
            sh[:, 1 : 1 + num_rest, ch] = f_rest[:, num_rest * ch : num_rest * (ch + 1)]

    if morton_sort and n > 1:
        perm = morton_order(position)
        position, scale, rot, sh, opacity = (
            a[perm] for a in (position, scale, rot, sh, opacity)
        )
    return GaussianTable.from_numpy(position, scale, rot, sh, opacity)


def raw_ply_columns_from_table(table: GaussianTable) -> dict:
    """Invert the load-time transforms of `from_raw_ply_columns`: the raw
    .ply property columns whose load reproduces `table` (up to float32
    exp/log and sigmoid/logit round trips), in numpy float32 exactly as the
    JAX package computes them.  `io.ply.write_gaussian_ply` exports tables
    with it, so procedural scenes can be loaded as captures."""
    t = table.to_numpy()
    pos = t["position"]
    xyz = np.stack([-pos[:, 0], -pos[:, 1], pos[:, 2]], axis=1)
    scales = np.log(np.maximum(t["scale"], 1e-30))
    r = t["rot"]
    # loaded (p, q, r, s) = (-c, -d, a, -b) of raw (a, b, c, d), so raw =
    # (r, -s, -p, -q)
    rots = np.stack([r[:, 2], -r[:, 3], -r[:, 0], -r[:, 1]], axis=1)
    o = np.clip(t["opacity"], 1e-6, 1.0 - 1e-6)
    opacities = np.log(o / (1.0 - o)).astype(np.float32)
    sh = t["sh"]
    num_rest = NUM_SH_COEFFS - 1
    f_rest = np.zeros((sh.shape[0], 3 * num_rest), np.float32)
    for ch in range(3):
        f_rest[:, num_rest * ch : num_rest * (ch + 1)] = sh[:, 1 : 1 + num_rest, ch]
    return dict(xyz=xyz, scales=scales, rots=rots, opacities=opacities, f_dc=sh[:, 0, :],
                f_rest=f_rest)


def make_gaussian(
    position,
    scale=(1.0, 1.0, 1.0),
    rot=(1.0, 0.0, 0.0, 0.0),
    color_sh0=(0.0, 0.0, 0.0),
    opacity=1.0,
) -> GaussianTable:
    """One already-activated gaussian (ResourceManager::addGaussian,
    ResourceManager.h:47: no load-time transforms), as a CPU table."""
    sh = np.zeros((1, NUM_SH_COEFFS, 3), dtype=np.float32)
    sh[0, 0] = np.asarray(color_sh0, dtype=np.float32)
    return GaussianTable.from_numpy([position], [scale], [rot], sh, [opacity])
