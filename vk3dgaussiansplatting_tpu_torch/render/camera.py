"""Fly camera with GLM-faithful view/projection matrices.

Port of `vk3dgaussiansplatting_tpu.render.camera`: the same numpy float32
host code, since the matrices are tiny per-frame uniforms (the reference's
camera UBO, ShaderStructs.h:37-41).  Reference: Engine/Graphics/Camera.{h,cpp}
— yaw/pitch direction vectors (Camera.cpp:7-25), `glm::lookAt` and
`glm::perspective(radians(90), aspect, 0.1, 100)` (Camera.cpp:27-48), and
the WASDQE / mouse fly controls (Camera.cpp:107-131) as `update` over an
`app.input.InputState` instead of GLFW polling.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.config import SphericalHarmonicsMode

NEAR_PLANE = 0.1  # Camera.cpp:4
FAR_PLANE = 100.0  # Camera.cpp:5


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.sqrt(np.float32((v * v).sum()))


def look_at(eye, center, up) -> np.ndarray:
    """glm::lookAtRH as a row-major [4,4] float32 matrix M with
    v_view = M @ v_world."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = normalize(center - eye)
    s = normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glm::perspectiveRH_NO (OpenGL -1..1 depth), row-major float32."""
    tan_half = math.tan(fov_y / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


class Camera:
    """Fly camera (reference: Camera.h:14-80).

    forward = (sin(yaw)·cos(pitch), sin(pitch), cos(yaw)·cos(pitch))
    (Camera.cpp:10-14).
    """

    MOVEMENT_SPEED = 2.0
    ROTATION_SPEED = 0.005

    def __init__(self, aspect: float = 16.0 / 9.0):
        self.position = np.zeros(3, dtype=np.float32)
        self.yaw = 0.0
        self.pitch = 0.0
        self.aspect = aspect
        self.sh_mode = SphericalHarmonicsMode.ALL_BANDS
        self.near_plane = NEAR_PLANE
        self.far_plane = FAR_PLANE
        self.fov_y = math.radians(90.0)  # Camera.cpp:42
        self._recalculate()

    def set_position(self, position) -> None:
        self.position = np.asarray(position, dtype=np.float32)
        self._recalculate()

    def set_rotation(self, yaw: float, pitch: float) -> None:
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self._recalculate()

    def set_sh_mode(self, mode: SphericalHarmonicsMode) -> None:
        """Hotkeys 1/2/3 in the reference (Camera.cpp:84-106)."""
        self.sh_mode = mode

    def set_aspect(self, aspect: float) -> None:
        self.aspect = float(aspect)
        self._recalculate()

    def rotate(self, d_yaw: float, d_pitch: float) -> None:
        self.yaw += d_yaw
        # Pitch clamped to +-half pi (Camera.cpp:125-130).
        self.pitch = min(
            max(self.pitch + d_pitch, -math.pi * 0.5 + 1e-3), math.pi * 0.5 - 1e-3
        )
        self._recalculate()

    def move_local(self, right: float, up: float, forward: float, dt: float = 1.0) -> None:
        self.position = (
            self.position
            + self.right_dir * np.float32(right * self.MOVEMENT_SPEED * dt)
            + self.up_dir * np.float32(up * self.MOVEMENT_SPEED * dt)
            + self.forward_dir * np.float32(forward * self.MOVEMENT_SPEED * dt)
        )
        self._recalculate()

    def update(self, input_state=None, dt: float = 0.0) -> None:
        """Per-frame update from an `app.input.InputState` with the
        reference's bindings (Camera.cpp:84-131): W/S, D/A and E/Q move
        forward, right and up (3x with shift), mouse look rotates while
        enabled, and 1/2/3 pick the SH mode.  Without input it does nothing;
        headless callers may call `rotate` / `move_local` instead."""
        if input_state is None:
            return
        speed = 3.0 if input_state.is_down("shift") else 1.0
        fwd = input_state.axis("w", "s")
        rgt = input_state.axis("d", "a")
        upa = input_state.axis("e", "q")
        if fwd or rgt or upa:
            self.move_local(rgt * speed, upa * speed, fwd * speed, dt)
        if input_state.mouse_look:
            dx, dy = input_state.mouse_delta
            self.rotate(-dx * self.ROTATION_SPEED, -dy * self.ROTATION_SPEED)
        for key, mode in (
            ("1", SphericalHarmonicsMode.ALL_BANDS),
            ("2", SphericalHarmonicsMode.SKIP_FIRST_BAND),
            ("3", SphericalHarmonicsMode.ONLY_FIRST_BAND),
        ):
            if input_state.is_down(key):
                self.sh_mode = mode

    def _recalculate(self) -> None:
        # Camera.cpp:7-25
        self.forward_dir = normalize(
            np.array(
                [
                    math.sin(self.yaw) * math.cos(self.pitch),
                    math.sin(self.pitch),
                    math.cos(self.yaw) * math.cos(self.pitch),
                ],
                dtype=np.float32,
            )
        )
        self.right_dir = normalize(
            np.cross(self.forward_dir, np.array([0.0, 1.0, 0.0], dtype=np.float32))
        )
        self.up_dir = normalize(np.cross(self.right_dir, self.forward_dir))
        self.view_matrix = look_at(
            self.position,
            self.position + self.forward_dir,
            np.array([0.0, 1.0, 0.0], dtype=np.float32),
        )
        self.projection_matrix = perspective(
            self.fov_y, self.aspect, self.near_plane, self.far_plane
        )

    def matrices(self):
        """(view, proj) float32 row-major [4,4] — the CamUBO payload."""
        return self.view_matrix, self.projection_matrix


# Pinned benchmark cameras (reference scene init):
def garden_benchmark_camera(aspect: float) -> Camera:
    """GardenScene.cpp:9-16."""
    cam = Camera(aspect)
    cam.set_position((-0.620010, 0.189628, 2.271181))
    cam.set_rotation(2.971590, -1.074159)
    return cam


def train_benchmark_camera(aspect: float) -> Camera:
    """TrainScene.cpp:9-21."""
    cam = Camera(aspect)
    cam.set_position((-2.857887, 0.188856, 1.048745))
    cam.set_rotation(1.361593, 0.005841)
    return cam


def bicycle_benchmark_camera(aspect: float) -> Camera:
    """BicycleScene.cpp:9-17."""
    cam = Camera(aspect)
    cam.set_position((0.945927, -0.294418, -0.181088))
    cam.set_rotation(-1.108407, -0.324159)
    return cam
