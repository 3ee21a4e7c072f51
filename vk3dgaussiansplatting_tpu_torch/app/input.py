"""Headless input state — the reference's GLFW `Input` static class
(Application/Input.{h,cpp}) without a window system; port of
`vk3dgaussiansplatting_tpu.app.input`.

Scripted callers push key and mouse state here; `Camera.update` consumes it
with the reference's bindings (WASDQE + shift + mouse look,
Camera.cpp:107-131; SH hotkeys 1/2/3, Camera.cpp:84-106).
"""

from __future__ import annotations


class InputState:
    def __init__(self):
        self._down: set[str] = set()
        self.mouse_look = False
        self.mouse_delta = (0.0, 0.0)

    def press(self, key: str) -> None:
        self._down.add(key.lower())

    def release(self, key: str) -> None:
        self._down.discard(key.lower())

    def is_down(self, key: str) -> bool:
        return key.lower() in self._down

    def axis(self, pos: str, neg: str) -> float:
        return float(self.is_down(pos)) - float(self.is_down(neg))

    def set_mouse(self, look: bool, dx: float = 0.0, dy: float = 0.0) -> None:
        self.mouse_look = look
        self.mouse_delta = (dx, dy)

    def end_frame(self) -> None:
        self.mouse_delta = (0.0, 0.0)
