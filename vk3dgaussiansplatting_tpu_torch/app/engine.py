"""Engine — the app shell and main loop; port of
`vk3dgaussiansplatting_tpu.app.engine`.

The reference `Engine` (Engine/Engine.{h,cpp}): subsystems in the same
order (renderer -> resources -> scene manager, Engine.cpp:35-38), then a
frame loop with dt bookkeeping, scene update, draw and a once-a-second FPS
log (Engine.cpp:45-78).  Headless: frames go to a callback instead of a
swapchain, and the loop runs a fixed number of frames.  The renderer runs
on the card unless the caller asks for the CPU (`device="cpu"`, the plain
versions of the kernels); without CUDA the default raises.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from ..core.config import RenderConfig
from ..pipeline import Renderer
from ..scenes.scene import Scene, SceneManager
from ..utils import log
from .input import InputState


class Engine:
    def __init__(self, config: RenderConfig, *, device="cuda", **renderer_kwargs):
        self.config = config
        self.renderer = Renderer(config, device=device, **renderer_kwargs)
        self.scene_manager = SceneManager(self.renderer)
        self.input = InputState()

    def init(self, scene: Scene) -> None:
        """Engine::init (Engine.cpp:32-43): queue the startup scene."""
        self.scene_manager.set_scene(scene)

    def run(
        self,
        num_frames: int,
        on_frame: Callable[[int, np.ndarray], None] | None = None,
        log_fps: bool = True,
    ) -> None:
        """The main loop (Engine.cpp:45-78); `on_frame(i, rgba_u8)` gets each
        frame on the host."""
        elapsed = 0.0
        fps_count = 0
        last = time.perf_counter()
        for frame in range(num_frames):
            self.scene_manager.update_to_next_scene()
            now = time.perf_counter()
            dt = now - last
            last = now

            scene = self.scene_manager.current
            scene.camera.update(self.input, dt)
            scene.update(dt)
            if self.input.is_down("t"):  # memory dump hotkey (Engine.cpp:64-69)
                from ..utils.debug import write_memory_dump

                log.write(f"memory dump -> {write_memory_dump()}")
                self.input.release("t")
            self.input.end_frame()

            out = self.renderer.draw(scene.camera)
            if on_frame is not None:
                on_frame(frame, out.image_u8.cpu().numpy())

            fps_count += 1
            elapsed += dt
            if log_fps and elapsed >= 1.0:  # FPS print (Engine.cpp:71-75)
                log.write(f"FPS: {fps_count / elapsed:.1f}")
                elapsed = 0.0
                fps_count = 0
