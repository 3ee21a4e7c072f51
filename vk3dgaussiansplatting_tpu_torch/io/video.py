"""Frame-sequence output for camera paths — port of
`vk3dgaussiansplatting_tpu.io.video`.

`VideoWriter.save` picks the format by the path: any path without a video
or GIF suffix is a directory, which gets a PNG sequence through the port's own encoder (io/image.py); `.mp4`,
`.mkv` and `.webm` need imageio (with its ffmpeg plugin), `.gif` PIL or
imageio.  Where the package a format needs cannot be imported, `save`
raises an error naming it.  The JAX writer falls back from a failed video
to a GIF under another name; this one never writes another format than
the one asked for.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
from pathlib import Path

import numpy as np

from .image import write_png

_VIDEO_SUFFIXES = (".mp4", ".mkv", ".webm")


def _installed(package: str) -> bool:
    return importlib.util.find_spec(package) is not None


def _missing(packages: str, what: str) -> RuntimeError:
    return RuntimeError(f"writing {what} needs {packages}, which is not installed here")


class VideoWriter:
    """Collects uint8 frames (RGB kept); `save` writes them."""

    def __init__(self):
        self.frames: list[np.ndarray] = []

    def add(self, frame_u8: np.ndarray) -> None:
        arr = np.asarray(frame_u8)
        if arr.dtype != np.uint8:
            raise TypeError("frames must be uint8")
        self.frames.append(arr[..., :3].copy())

    def save(self, path: str, fps: int = 30) -> str:
        """Write the frames to `path` (see the module docstring); returns it."""
        if not self.frames:
            raise ValueError("no frames to save")
        path = str(path)
        ext = Path(path).suffix.lower()
        if ext in _VIDEO_SUFFIXES:
            if not _installed("imageio"):
                raise _missing("the 'imageio' package", f"{ext} video")
            importlib.import_module("imageio.v3").imwrite(path, np.stack(self.frames), fps=fps)
        elif ext == ".gif":
            duration = max(1000 // fps, 20)
            if _installed("PIL"):
                image = importlib.import_module("PIL.Image")
                imgs = [image.fromarray(f) for f in self.frames]
                imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=duration,
                             loop=0)
            elif _installed("imageio"):
                importlib.import_module("imageio.v3").imwrite(
                    path, np.stack(self.frames), duration=duration, loop=0)
            else:
                raise _missing("the 'PIL' or the 'imageio' package", "a GIF")
        else:
            os.makedirs(path, exist_ok=True)
            for i, f in enumerate(self.frames):
                write_png(os.path.join(path, f"frame_{i:05d}.png"), f)
        return path
