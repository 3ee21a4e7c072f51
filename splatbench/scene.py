"""The benchmark's scene, camera and camera loop.

The scene is a procedural cloud made on the device from `--seed`, with the
distributions of the stand-in cloud every earlier measurement of this
renderer used (half the gaussians normal about the origin, half uniform
over the extent, log-normal scales, random unit quaternions, bimodal
"capture" opacities, SH colour), in a few large calls on one CUDA
generator.  A scale multiplier is then calibrated so that the camera's
frame holds the configuration's published live element count, counted by
the reference's own projection.

The camera is the benchmark's own: `matrices()` and `position`, from its
own look-at and perspective (glm's lookAt and perspective, OpenGL depth).
The loop is a closed circle of poses in the camera's right/up plane around
the calibrated pose; each frame takes the next pose, so every frame has new
matrices and the work repeats with the period.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference
from .reference import Cloud


def make_cloud(n: int, cloud: dict, seed: int, device) -> Cloud:
    """`n` gaussians drawn from the distributions of `cloud` (the
    configuration's `assumed.cloud`), float32 on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    f32 = dict(dtype=torch.float32, device=device)
    nc = int(n * cloud["cluster_fraction"])
    ext = cloud["extent"]
    pos = torch.empty((n, 3), **f32)
    pos[:nc].normal_(0.0, ext * cloud["cluster_std_of_extent"], generator=g)
    pos[nc:].uniform_(-ext, ext, generator=g)
    scale = torch.empty((n, 3), **f32).normal_(cloud["scale_log_mean"], cloud["scale_log_std"],
                                               generator=g).exp_()
    rot = torch.empty((n, 4), **f32).normal_(generator=g)
    rot /= torch.linalg.vector_norm(rot, dim=1, keepdim=True)
    mean, std = cloud["opacity_logit"]
    opacity = torch.empty(n, **f32).normal_(mean, std, generator=g).sigmoid_()
    sh = torch.empty((n, 16, 3), **f32).normal_(0.0, cloud["sh_rest_std"], generator=g)
    sh[:, 0, :].uniform_(*cloud["sh_dc_range"], generator=g)
    perm = torch.randperm(n, generator=g, device=device)
    return Cloud(pos[perm], scale[perm], rot[perm], sh[perm], opacity[perm])


def scaled(cloud: Cloud, mult: float) -> Cloud:
    """The cloud with every scale times the float32 `mult`."""
    return cloud._replace(scale=cloud.scale * float(np.float32(mult)))


def _normalize(v):
    return v / np.sqrt(np.float32((v * v).sum()))


def look_at(eye, center, up) -> np.ndarray:
    """Row-major [4, 4] float32 view matrix, v_view = M v_world."""
    f = _normalize(center - eye)
    s = _normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -np.dot(s, eye), -np.dot(u, eye), np.dot(f, eye)
    return m


def perspective(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Row-major [4, 4] float32 projection, depth -1..1."""
    t = math.tan(fov_y / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


class Camera:
    """A pose: `position` [3] float32 and `matrices()` -> (view, proj)."""

    def __init__(self, position, forward, up, proj):
        self.position = np.asarray(position, dtype=np.float32)
        self.view = look_at(self.position, self.position + forward, up)
        self.proj = proj

    def matrices(self):
        return self.view, self.proj


class Orbit:
    """A closed loop of `poses` cameras on a circle of circumference
    `poses * step` in the right/up plane of the base pose (`camera`, the
    configuration's `assumed.camera`), starting at pose `phase`."""

    def __init__(self, camera: dict, aspect: float, poses: int, step: float, phase: int):
        yaw, pitch = camera["yaw"], camera["pitch"]
        self.base = np.asarray(camera["position"], dtype=np.float32)
        self.forward = _normalize(np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                                            math.cos(yaw) * math.cos(pitch)], dtype=np.float32))
        self.world_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        self.right = _normalize(np.cross(self.forward, self.world_up))
        self.up = _normalize(np.cross(self.right, self.forward))
        self.proj = perspective(math.radians(camera["fov_y_deg"]), aspect, camera["near"],
                                camera["far"])
        self.poses, self.phase = poses, phase % poses
        self.radius = poses * step / (2.0 * math.pi)

    def centre(self) -> Camera:
        return Camera(self.base, self.forward, self.world_up, self.proj)

    def camera(self, i: int) -> Camera:
        """The camera of frame i: pose (phase + i) mod poses."""
        a = 2.0 * math.pi * ((self.phase + i) % self.poses) / self.poses
        off = self.radius * (math.cos(a) * self.right + math.sin(a) * self.up)
        return Camera(self.base + off.astype(np.float32), self.forward, self.world_up, self.proj)


def calibrate(cloud: Cloud, cam: Camera, fr: reference.Frame, target: int, tol: float,
              *, steps: int = 48) -> tuple[float, int]:
    """Bisect the scale multiplier (in log space, between 0.05 and 20) until
    the reference's live count at `cam` is within `tol` of `target`.
    Returns (multiplier, live count); raises if 3% is not reached."""
    view, proj = cam.matrices()

    def count(m):
        return reference.live_count(scaled(cloud, m), view, proj, cam.position, fr)

    lo, hi = math.log(0.05), math.log(20.0)
    best = None
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        live = count(math.exp(mid))
        if best is None or abs(live - target) < abs(best[1] - target):
            best = (math.exp(mid), live)
        if abs(live - target) <= tol * target:
            break
        lo, hi = (mid, hi) if live < target else (lo, mid)
    mult, live = best
    if abs(live - target) > 0.03 * target:
        raise RuntimeError(f"calibration missed: {live} live against the target {target}")
    return mult, live
