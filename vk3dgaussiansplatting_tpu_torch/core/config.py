"""Render configuration — PyTorch port of `vk3dgaussiansplatting_tpu.core.config`.

The fields, defaults and derived sizes are those of the JAX package, field
for field, so that one configuration describes the same frame in both.
Two fields only ever shaped the TPU kernels' schedules and are kept for
that parity alone:

  * `expansion_method`: "auto", "pallas" and "stream" all select the CUDA
    expansion kernel (ops/cuda/expand_kernel.py) when the tables lie on a
    CUDA device; "repeat" selects its plain PyTorch version.
  * `blend_batch_k`: the TPU blend's lane batch.  The CUDA blend stages its
    own fixed batch through shared memory and does not read it.

The capped/prefilter fields (`blend_depth_cap` and the fields after it)
belong to the temporal capped path, which this port does not have yet;
`pipeline.Renderer` refuses `blend_depth_cap > 0` rather than blending
uncapped.
"""

from __future__ import annotations

import dataclasses
import enum
import math


class SphericalHarmonicsMode(enum.IntEnum):
    """SH evaluation modes, hotkeys 1/2/3 in the reference (Camera.h:7-12)."""

    ALL_BANDS = 0
    SKIP_FIRST_BAND = 1
    ONLY_FIRST_BAND = 2


class SortAlgorithm(enum.Enum):
    """Sort strategy selection (reference: `GPU_SORT_ALGORITHM`, Renderer.h:33).

    XLA_SORT — a stable sort on one int64 (tile, depth) key
               (ops/sort.py); AUTO means the same.
    BITONIC  — the reference's bitonic merge network; not ported yet.
    """

    XLA_SORT = "xla_sort"
    BITONIC = "bitonic"
    AUTO = "auto"


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def ceil_pow_two(x: int) -> int:
    """Reference: Renderer::getCeilPowTwo (Renderer.cpp:703-710)."""
    num = 1
    while num < x:
        num *= 2
    return num


def min_num_bits(x: int) -> int:
    """Number of bits needed to represent x (RadixSort::getMinNumBits)."""
    return max(x.bit_length(), 1)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static per-scene/per-resolution render configuration.

    Mirrors the reference tunables:
      - tile_size:   TILE_SIZE=16 (Renderer.h:146, Common.glsl:12)
      - near/far:    Camera::NEAR_PLANE=0.1 / FAR_PLANE=100 (Camera.cpp:4-5)
      - fov_y:       the shader hard-codes 3.1415f*0.5f (Common.glsl:2), the
                     projection matrix uses glm::radians(90.0); both kept.
      - culling_ndc_limit: CULLING_NDC_LIMIT=1.3 (Common.glsl:5)
      - in_view_limit:     IN_VIEW_LIMIT=0.8 (Common.glsl:9)
      - covariance_dilation: +0.3 on cov.x/cov.z (Common.glsl:73-75)
      - alpha_cutoff / transmittance_stop: RenderGaussians.comp:127,136
    """

    width: int = 1280
    height: int = 720
    tile_size: int = 16
    near_plane: float = 0.1
    far_plane: float = 100.0
    shader_fov_y: float = 3.1415 * 0.5
    proj_fov_y: float = math.radians(90.0)
    culling_ndc_limit: float = 1.3
    in_view_limit: float = 0.8
    covariance_dilation: float = 0.3
    alpha_cutoff: float = 1.0 / 255.0
    transmittance_stop: float = 1.0e-4
    sh_mode: SphericalHarmonicsMode = SphericalHarmonicsMode.ALL_BANDS
    sort_algorithm: SortAlgorithm = SortAlgorithm.AUTO
    # Reference capacity formula: ceilPow2(numGaussians + 64*16*numTiles)
    # (Renderer.cpp:725).
    capacity_slack_per_tile: int = 64 * 16
    capacity_pow_two: bool = True
    expansion_method: str = "auto"
    blend_batch_k: int = 768
    # Temporal capped path (slice 2, not ported): see the module docstring.
    blend_depth_cap: int = 0
    blend_cap_max: int = 4096
    packed_slack_per_tile: int = 256
    cap_escalate_margin: float = 0.3
    thr_publish_margin: float = 1.0
    cap_decay_margin: float = 0.02
    cap_validation_factor: float = 4.0
    thr_reset_damp: bool = True

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def grid_width(self) -> int:
        """Tiles along x (Renderer::getNumTiles, Renderer.cpp:696-701)."""
        return ceil_div(self.width, self.tile_size)

    @property
    def grid_height(self) -> int:
        return ceil_div(self.height, self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.grid_width * self.grid_height

    def sort_capacity(self, num_gaussians: int) -> int:
        """Reference: Renderer.cpp:725."""
        cap = num_gaussians + self.capacity_slack_per_tile * self.num_tiles
        if self.capacity_pow_two:
            cap = ceil_pow_two(cap)
        return cap

    @property
    def num_tile_bits(self) -> int:
        """Bits needed for the tile id (RadixSort.cpp:203)."""
        return max((self.num_tiles - 1).bit_length(), 1)

    def num_sort_bits(self, bits_per_pass: int = 4) -> int:
        """Used key bits rounded up to the pass size (RadixSort.cpp:203-204)."""
        sort_bits = 32 + self.num_tile_bits
        return ceil_div(sort_bits, bits_per_pass) * bits_per_pass


# Sentinel key marking unused sort-list capacity: the reference clears the
# sort list to 0xFFFFFFFF (Subrenderer.cpp:42-46).  The port carries keys in
# int64 tensors, where this value is an ordinary positive number.
SENTINEL = 0xFFFFFFFF

# 2^32 - 1 (MAX_UINT32 in Common.glsl:15)
MAX_UINT32 = 0xFFFFFFFF
