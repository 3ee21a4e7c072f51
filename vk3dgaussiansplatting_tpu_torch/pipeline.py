"""Frame pipeline — the reference `Renderer`, in PyTorch.

Port of the uncapped path of `vk3dgaussiansplatting_tpu.pipeline`: the frame
is the reference's pass sequence (recordCommandBuffer, Renderer.cpp:540-629)
run as eager tensor code on one device,

    keygen (cull + keys + SH, K1 expansion)  ->  sort  ->  find_ranges
        ->  blend (K2)  ->  quantize

`Renderer.init_for_scene` plays the reference's initForScene
(Renderer.cpp:712-756): it fixes the capacity (the same
`ceilPow2(N + 64*16*tiles)` formula) and uploads the table once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core.config import RenderConfig
from .models.gaussians import GaussianTable
from .ops import blend as blend_ops
from .ops import keygen as keygen_ops
from .ops import ranges as ranges_ops
from .ops import sort as sort_ops
from .ops.cuda import blend_kernel
from .utils.timing import section


class FrameOutputs(NamedTuple):
    """One rendered frame plus inspection intermediates.  `ok` is None: it
    belongs to the capped path, which is not ported."""

    image_u8: torch.Tensor  # [H, W, 4] uint8 rgba
    image: torch.Tensor  # [H, W, 3] float32 pre-quantization
    num_elements: torch.Tensor  # [] int64 live sort elements
    ok: torch.Tensor | None = None


def render_frame(
    table: GaussianTable,
    view: np.ndarray,
    proj: np.ndarray,
    cam_pos: np.ndarray,
    *,
    config: RenderConfig,
    capacity: int,
    use_kernels: bool,
    timer=None,
) -> FrameOutputs:
    """The full uncapped frame.  `use_kernels` selects the CUDA kernels'
    wrappers (which still run the plain versions on CPU tensors) or the plain
    versions outright.  `timer` (utils.timing.CudaPassTimer) records the
    passes keygen, expand (inside keygen), sort, ranges and blend."""
    with section(timer, "keygen"):
        elements, frame = keygen_ops.generate_sort_elements(
            table, view, proj, cam_pos, config, capacity,
            use_kernels=use_kernels, timer=timer,
        )
    with section(timer, "sort"):
        elements = sort_ops.sort_elements(elements, config)
    with section(timer, "ranges"):
        ranges = ranges_ops.find_ranges(elements, config.num_tiles)
    with section(timer, "blend"):
        table_rows = blend_kernel.pack_feature_table(frame)
        if use_kernels:
            image = blend_kernel.blend_rows(table_rows, elements.index, ranges, config)
        else:
            image = blend_ops.blend_rows_plain(table_rows, elements.index, ranges, config)
    return FrameOutputs(
        image_u8=blend_ops.quantize_image(image),
        image=image,
        num_elements=elements.count,
    )


class Renderer:
    """Scene-bound renderer (reference: Renderer + initForScene).

    Args:
      config: render configuration.
      device: the torch device every tensor of the frame lives on.
      use_kernels: None means the CUDA kernels exactly when `device` is CUDA;
        False runs the plain versions on any device.
    """

    def __init__(self, config: RenderConfig, *, device, use_kernels: bool | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        if use_kernels and config.blend_depth_cap > 0:
            raise NotImplementedError(
                "blend_depth_cap > 0 selects the temporal capped blend, which is "
                "not ported yet (ROADMAP slice 2); use blend_depth_cap=0"
            )
        self.config = config
        self.use_kernels = use_kernels
        self.table: GaussianTable | None = None
        self.capacity: int | None = None

    def init_for_scene(self, table: GaussianTable) -> None:
        """Upload the gaussian table and fix the capacity (Renderer.cpp:712)."""
        self.capacity = self.config.sort_capacity(table.num_gaussians)
        self.table = table.to(self.device)

    def draw(self, camera, timer=None) -> FrameOutputs:
        """Render one frame from a `render.camera.Camera`."""
        if self.table is None:
            raise RuntimeError("call init_for_scene() first")
        view, proj = camera.matrices()
        return render_frame(
            self.table,
            view,
            proj,
            camera.position,
            config=self.config,
            capacity=self.capacity,
            use_kernels=self.use_kernels,
            timer=timer,
        )

    def draw_numpy(self, camera) -> np.ndarray:
        """Render and fetch to host ([H, W, 4] uint8 rgba)."""
        return self.draw(camera).image_u8.cpu().numpy()
