"""Camera-path flythrough rendering — port of
`vk3dgaussiansplatting_tpu.app.flythrough`: interpolates position / yaw /
pitch keyframes, renders each frame with an initialised Renderer and hands
it to a VideoWriter (io/video.py); the headless equivalent of flying the
reference's camera (WASDQE) while presenting.
"""

from __future__ import annotations

import numpy as np

from ..io.video import VideoWriter
from ..render.camera import Camera


def interpolate_path(keyframes, num_frames: int):
    """keyframes: list of (position[3], yaw, pitch). Piecewise-linear."""
    if len(keyframes) < 2:
        raise ValueError("need at least two keyframes")
    pos = np.asarray([k[0] for k in keyframes], dtype=np.float32)
    yaw = np.asarray([k[1] for k in keyframes], dtype=np.float32)
    pitch = np.asarray([k[2] for k in keyframes], dtype=np.float32)
    t = np.linspace(0.0, len(keyframes) - 1.0, num_frames)
    i = np.clip(t.astype(np.int32), 0, len(keyframes) - 2)
    frac = (t - i).astype(np.float32)
    out = []
    for n in range(num_frames):
        a, f = i[n], frac[n]
        out.append(
            (
                pos[a] * (1 - f) + pos[a + 1] * f,
                float(yaw[a] * (1 - f) + yaw[a + 1] * f),
                float(pitch[a] * (1 - f) + pitch[a + 1] * f),
            )
        )
    return out


def render_flythrough(
    renderer,
    keyframes,
    num_frames: int,
    *,
    aspect: float | None = None,
    writer: VideoWriter | None = None,
) -> VideoWriter:
    """Render `num_frames` along the path with an initialised Renderer."""
    writer = writer or VideoWriter()
    cam = Camera(aspect or renderer.config.aspect)
    for position, yaw, pitch in interpolate_path(keyframes, num_frames):
        cam.set_position(position)
        cam.set_rotation(yaw, pitch)
        writer.add(renderer.draw_numpy(cam))
    return writer
