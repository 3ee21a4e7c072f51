"""Frame pipeline — the reference `Renderer`, in PyTorch.

Port of `vk3dgaussiansplatting_tpu.pipeline`: the frame is the reference's
pass sequence (recordCommandBuffer, Renderer.cpp:540-629) run as eager
tensor code on one device,

    keygen (cull + keys + SH, rows in depth order, K1 / K1' expansion)
        ->  sort (the tile)  ->  find_ranges
        ->  blend  ->  quantize

where the blend is K2 (uncapped, `blend_depth_cap == 0`) or the capped blend
of ops/capped.py (K5 layout ids, K3 blend with its
transmittance read-back): the static cap in `render_frame`, the temporal
per-tile caps in `render_frame_temporal`, and, for scenes above
`Renderer.BIG_SCENE_CAPACITY`, `ChainedTemporalPlan` with the depth
prefilter's steady set.

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
from .ops import capped as capped_ops
from .ops import keygen as keygen_ops
from .ops import ranges as ranges_ops
from .ops import sort as sort_ops
from .utils.timing import count, read_back, section


class FrameOutputs(NamedTuple):
    """One rendered frame plus inspection intermediates.

    `ok` is a [] bool tensor on the frame's device (None on the uncapped and
    static-cap paths): True when every tile validated or was patched, i.e.
    the frame is exact within the quantized-image contract.  False marks a
    degraded frame (a steady-capacity overflow, or an unpatchable
    prefiltered tile) or one that took the full fallback.  Reading it on
    the host synchronises with the device.
    """

    image_u8: torch.Tensor  # [H, W, 4] uint8 rgba
    image: torch.Tensor  # [H, W, 3] float32 pre-quantization
    num_elements: torch.Tensor  # [] int64 live sort elements
    ok: torch.Tensor | None = None


def _sorted_frame(table, view, proj, cam_pos, config, capacity, timer, depth_thr=None, *,
                  reads_depth=True):
    """keygen -> sort -> ranges: (sorted elements, ranges, frame data).  On
    the radix path (`sort_ops.depth_first`) keygen expands its rows in
    depth order and the sort keys the tile alone; there, for a caller that
    reads no sorted depth (`reads_depth` False), the sort carries the tile
    and the index alone and the elements' depth is None."""
    depth_first = sort_ops.depth_first(config)
    with section(timer, "keygen"):
        elements, frame = keygen_ops.generate_sort_elements(
            table, view, proj, cam_pos, config, capacity, depth_thr, depth_order=depth_first,
            timer=timer,
        )
    with section(timer, "sort"):
        if depth_first and not reads_depth:
            elements = elements._replace(depth=None)
        elements = sort_ops.sort_elements(elements, config, timer, depth_ordered=depth_first)
    with section(timer, "ranges"):
        ranges = ranges_ops.find_ranges(elements, config.num_tiles)
    return elements, ranges, frame


def render_frame(
    table: GaussianTable,
    view: np.ndarray,
    proj: np.ndarray,
    cam_pos: np.ndarray,
    *,
    config: RenderConfig,
    capacity: int,
    timer=None,
) -> FrameOutputs:
    """The full frame: the K2 blend, or with `blend_depth_cap > 0` the
    static-cap capped blend.  The kernels' wrappers run the plain versions
    on CPU tensors.  `timer` (utils.timing.CudaPassTimer) records
    the passes keygen (project, depth_order and expand inside it), sort,
    ranges, blend and quantize."""
    # K2 reads the sorted index and the ranges the tile; the capped blend
    # reads the sorted depth too.
    elements, ranges, frame = _sorted_frame(
        table, view, proj, cam_pos, config, capacity, timer,
        reads_depth=config.blend_depth_cap > 0,
    )
    with section(timer, "blend"):
        if config.blend_depth_cap > 0:
            image = capped_ops.blend_tiles_capped(elements, ranges, frame, config, timer=timer)
        else:
            image = blend_ops.blend_tiles(elements, ranges, frame, config)
    with section(timer, "quantize"):
        image_u8 = blend_ops.quantize_image(image)
    return FrameOutputs(
        image_u8=image_u8,
        image=image,
        num_elements=elements.count,
    )


def render_frame_temporal(
    table: GaussianTable,
    view: np.ndarray,
    proj: np.ndarray,
    cam_pos: np.ndarray,
    caps,
    *,
    config: RenderConfig,
    capacity: int,
    timer=None,
):
    """Frame with the temporal per-tile-caps blend (ops/capped.py).

    `caps` is the previous frame's cap state (capped_ops.init_caps to
    start); returns (FrameOutputs, caps_next).  Keygen is unfiltered, as in
    the JAX package.  `timer` records keygen, expand, sort, ranges, the
    capped passes layout, blend, policy and patch, and quantize."""
    elements, ranges, frame = _sorted_frame(
        table, view, proj, cam_pos, config, capacity, timer
    )
    image, caps_next, ok = capped_ops.blend_tiles_capped_temporal(
        elements, ranges, frame, config, caps, timer=timer
    )
    with section(timer, "quantize"):
        image_u8 = blend_ops.quantize_image(image)
    return (
        FrameOutputs(
            image_u8=image_u8,
            image=image,
            num_elements=elements.count,
            ok=ok,
        ),
        caps_next,
    )


class _PendingFlag:
    """A device bool copied to pinned host memory without blocking;
    `tolist()` (through `utils.timing.read_back`) waits for the copy's
    event, long done a window later."""

    def __init__(self, flag: torch.Tensor):
        self._host = torch.empty((), dtype=torch.bool, pin_memory=True)
        self._host.copy_(flag, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def tolist(self) -> bool:
        self._event.synchronize()
        return self._host.item()


class ChainedTemporalPlan:
    """The big-scene frame plan: the temporal capped blend with the depth
    prefilter's steady set (JAX pipeline.py:140-433).

    Each frame runs keygen -> sort -> ranges -> capped layout -> capped
    finish with the CapsState (caps, prefilter thresholds, decay floors)
    carried across frames on the device.  After the warm-up frames the
    caller may call `try_steady_switch()`: keygen then drops the gaussians
    behind the published thresholds and every per-element pass runs at
    `steady_frac` of the full capacity.

    On the TPU this plan dispatches one program per pass (and fuses the
    steady passes) to work around its compiler; in eager PyTorch the passes
    are the same code either way, so there is one frame path, and every
    `last_*` field describes the last frame.
    """

    def __init__(
        self,
        config: RenderConfig,
        capacity: int,
        *,
        device,
        steady_frac: float = 0.51,
        log=None,
    ):
        assert config.blend_depth_cap > 0, "temporal plan needs a cap"
        self.config = config
        self.capacity = capacity
        self.device = torch.device(device)
        self.prefilter_on = steady_frac > 0
        self.steady_capacity = (
            -(-int(capacity * steady_frac) // 512) * 512 if self.prefilter_on else None
        )
        self.state = (
            capped_ops.init_caps_state(config, self.device)
            if self.prefilter_on
            else capped_ops.init_caps(config, self.device)
        )
        self.mode = "full"  # "full" | "steady"
        self.steady_declined = False  # a failed switch is not retried
        self.frames = 0
        self._log = log or (lambda *a: None)
        # Device tensors of the last frame (reading one on the host syncs).
        self.last_ok = None
        self.last_stats = None
        self.last_count = None
        self.last_overflow = None
        # Opt-in: keep the last frame's sorted elements, ranges and frame
        # data (they pin an E-sized list on the device).
        self.keep_intermediates = False
        self.last_elements = None
        self.last_ranges = None
        self.last_frame = None
        # OR of every steady frame's overflow flag since the last
        # take_overflow_acc(), on the device.
        self._ovf_acc = None

    def materialize_intermediates(self):
        """The last frame's (sorted elements, ranges, frame data), kept with
        `keep_intermediates`.  The JAX plan recomputes them here because its
        fused steady program does not return them; the port's one frame
        path keeps them as they were."""
        return self.last_elements, self.last_ranges, self.last_frame

    def frame(self, table, view, proj, cam_pos, timer=None):
        """Run one frame; returns the [H, W, 3] float32 image on the device.
        Nothing is read back except the capped blend's branch flags."""
        filtered = self.mode == "steady"
        cap_e = self.steady_capacity if filtered else self.capacity
        el, rg, fr = _sorted_frame(
            table, view, proj, cam_pos, self.config, cap_e, timer,
            depth_thr=self.state.thr if filtered else None,
        )
        img, self.state, ok, stats = capped_ops.blend_tiles_capped_split(
            el, rg, fr, self.config, self.state, timer=timer
        )
        if filtered:
            # A steady-capacity overflow truncates the element list for
            # arbitrary tiles while range-fit validation still passes: flag
            # the frame, and let Renderer.draw's periodic check revert.
            overflow = el.count >= cap_e
            ok = ok & ~overflow
            self._ovf_acc = overflow if self._ovf_acc is None else self._ovf_acc | overflow
        else:
            overflow = None
        self.last_ok, self.last_stats, self.last_count = ok, stats, el.count
        self.last_overflow = overflow
        if self.keep_intermediates:
            self.last_elements, self.last_ranges, self.last_frame = el, rg, fr
        self.frames += 1
        return img

    def take_overflow_acc(self):
        """Pop the accumulated steady-overflow flag (None if no steady frame
        ran since the last call).  On CUDA its host copy starts without
        blocking: read it a window later (`read_back`), stale but
        sync-free."""
        acc, self._ovf_acc = self._ovf_acc, None
        if acc is not None and acc.device.type == "cuda":
            return _PendingFlag(acc)
        return acc

    def try_steady_switch(self, table, view, proj, cam_pos, probes: int = 3, *, timer=None):
        """Probe the prefiltered live count and switch to the steady set.

        Reads the live count back (host syncs: keep it out of timing) and
        flips to steady mode if the filtered list fits the smaller capacity,
        then runs `probes` steady frames and reverts on an overflow.
        Returns True on switch.  `timer` counts `steady_switch` or
        `steady_declined` and records the probe frames' sections."""
        if not self.prefilter_on or self.mode == "steady" or self.steady_declined:
            return self.mode == "steady"
        est = read_back(timer, keygen_ops.count_live_elements(
            table, view, proj, cam_pos, self.config, depth_thr=self.state.thr
        ))
        if est >= int(self.steady_capacity * 0.97):
            self._log(
                f"steady switch skipped: filtered live ~{est/1e6:.2f}M "
                f">= {self.steady_capacity/1e6:.2f}M steady capacity"
            )
            self.steady_declined = True
            count(timer, "steady_declined")
            return False
        self.mode = "steady"
        for j in range(probes):
            self.frame(table, view, proj, cam_pos, timer=timer)
            cnt, *stats = read_back(timer, torch.cat([self.last_count.reshape(1),
                                                      self.last_stats]))
            self._log(
                f"  steady probe {j}: live={cnt/1e6:.2f}M/{self.steady_capacity/1e6:.2f}M "
                f"stats={stats}"
            )
            if cnt >= self.steady_capacity:
                self.mode = "full"
                self.steady_declined = True
                count(timer, "steady_declined")
                self._log("steady capacity overflow; staying on full set")
                # The overflow frame dropped arbitrary elements; let the
                # temporal state re-validate on the full set.
                for _ in range(2):
                    self.frame(table, view, proj, cam_pos, timer=timer)
                return False
        count(timer, "steady_switch")
        return True


class Renderer:
    """Scene-bound renderer (reference: Renderer + initForScene).

    Args:
      config: render configuration.  `blend_depth_cap > 0` selects the
        temporal capped blend (the JAX package's production path): the
        monolithic temporal frame, or `ChainedTemporalPlan` above
        `BIG_SCENE_CAPACITY`.  JAX gates it on its Pallas tier too, because
        its XLA tier has no capped blend; every kernel of the port has a
        plain version, so here the config alone selects it.
      device: the torch device every tensor of the frame lives on.  On
        CUDA every pass runs its kernel; on the CPU the kernels' wrappers run
        their plain versions.
      steady_frac: the chained plan's steady capacity as a share of the full
        capacity (0 disables the prefilter).
      log: a callable taking one message; the chained plan reports its
        steady switch through it.
    """

    # Capacity above which the chained plan (with the prefilter's steady
    # set) runs: the JAX package's threshold, kept so both packages pick the
    # same plan for a scene.
    BIG_SCENE_CAPACITY = 6_000_000
    # Full-capacity frames before the chained plan probes the steady switch.
    WARMUP_FRAMES = 14

    def __init__(
        self,
        config: RenderConfig,
        *,
        device,
        steady_frac: float = 0.51,
        log=None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self.config = config
        self.temporal_caps = config.blend_depth_cap > 0
        self.steady_frac = steady_frac
        self._log = log
        self._caps = None
        self._ovf_pending = None  # the previous window's overflow flag
        self._plan: ChainedTemporalPlan | None = None
        self.table: GaussianTable | None = None
        self.capacity: int | None = None

    def init_for_scene(self, table: GaussianTable) -> None:
        """Upload the gaussian table and fix the capacity (Renderer.cpp:712)."""
        self.capacity = self.config.sort_capacity(table.num_gaussians)
        self._caps = None  # temporal caps reset on scene swap
        self._ovf_pending = None
        self._plan = None
        if self.temporal_caps and self.capacity > self.BIG_SCENE_CAPACITY:
            self._plan = ChainedTemporalPlan(
                self.config, self.capacity, device=self.device,
                steady_frac=self.steady_frac, log=self._log,
            )
        self.table = table.to(self.device)

    def _draw_plan(self, view, proj, cam_pos, timer) -> FrameOutputs:
        plan = self._plan
        args = (self.table, view, proj, cam_pos)
        if plan.mode == "full" and plan.prefilter_on and plan.frames >= self.WARMUP_FRAMES:
            plan.try_steady_switch(*args, timer=timer)
        image = plan.frame(*args, timer=timer)
        if plan.mode == "steady" and plan.frames % 8 == 0:
            # Fetch-free overflow check: pop the device OR of this window's
            # overflow flags and read the previous window's, whose host copy
            # has had a window to land.
            pending = plan.take_overflow_acc()
            stale = self._ovf_pending
            self._ovf_pending = pending
            if stale is not None and read_back(timer, stale):
                # The filtered list outgrew the steady capacity: those frames
                # were flagged; revert to the full set, re-probe later.
                plan.mode = "full"
                plan.steady_declined = False
                self._ovf_pending = None
                count(timer, "steady_revert")
        with section(timer, "quantize"):
            image_u8 = blend_ops.quantize_image(image)
        return FrameOutputs(
            image_u8=image_u8,
            image=image,
            num_elements=plan.last_count,
            ok=plan.last_ok,
        )

    def draw(self, camera, timer=None) -> FrameOutputs:
        """Render one frame from a `render.camera.Camera`.  `timer`
        (utils.timing.CudaPassTimer) records the frame as one `frame` span
        with the passes' spans under it."""
        if self.table is None:
            raise RuntimeError("call init_for_scene() first")
        with section(timer, "frame"):
            return self._draw(camera, timer)

    def _draw(self, camera, timer) -> FrameOutputs:
        view, proj = camera.matrices()
        if self._plan is not None:
            return self._draw_plan(view, proj, camera.position, timer)
        if self.temporal_caps:
            if self._caps is None:
                self._caps = capped_ops.init_caps(self.config, self.device)
            out, self._caps = render_frame_temporal(
                self.table, view, proj, camera.position, self._caps,
                config=self.config, capacity=self.capacity, timer=timer,
            )
            return out
        return render_frame(
            self.table,
            view,
            proj,
            camera.position,
            config=self.config,
            capacity=self.capacity,
            timer=timer,
        )

    def draw_numpy(self, camera) -> np.ndarray:
        """Render and fetch to host ([H, W, 4] uint8 rgba)."""
        return self.draw(camera).image_u8.cpu().numpy()
