#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vk3dgaussiansplatting_tpu_torch) on one
NVIDIA GPU, through `Renderer` as a user drives it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, one line each (any failure raises, and the exit code is non-zero):

  device   the card's name, and name + power limit from nvidia-smi
  build    both CUDA kernels compiled from csrc/ (seconds, ptxas report)
  fixture  the fixture scenes on the card (kernels) against the CPU (plain
           versions): element counts equal, 8-bit ±1 per channel
  scene    train7k_720p: the benchmark stand-in cloud (559,263 gaussians,
           1280x720, capacity 4,245,663), scale calibrated to 3,487,911 live
           elements ±3%; 3 warm-up + 20 timed frames with the camera nudged
           each frame; median ms/frame and per-pass ms from CUDA events
  check    on that scene's last frame: keygen/sort/ranges on the card ==
           on the CPU bit for bit; K1 == its plain version bit for bit (and
           on edge cases); K2 vs its plain version per channel 8-bit
           max |Δ| <= 2 with |Δ| > 1 on at most 1e-4 of pixel-channels;
           kernel and plain times
  scene    garden30k_1080p: 5,834,784 gaussians at 1920x1080, capacity
           14,190,624, calibrated to 13,098,506 live ±3%; 3 warm-up + 10
           timed frames; the same checks of K1 and K2
  launches both kernels launched during each scene's frames

Then one JSON line with each kernel's launches, error and times, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from vk3dgaussiansplatting_tpu_torch.core.config import RenderConfig
from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable
from vk3dgaussiansplatting_tpu_torch.ops import blend as blend_ops
from vk3dgaussiansplatting_tpu_torch.ops import keygen, ranges, sort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import _build, blend_kernel, expand_kernel
from vk3dgaussiansplatting_tpu_torch.pipeline import Renderer
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic
from vk3dgaussiansplatting_tpu_torch.utils.timing import CudaPassTimer

# name: (gaussians, width, height, target live elements, timed frames);
# the JAX benchmark's stand-in settings (bench.py:41-44).
SCENES = {
    "train7k_720p": (559_263, 1280, 720, 3_487_911, 20),
    "garden30k_1080p": (5_834_784, 1920, 1080, 13_098_506, 10),
}
WARMUP_FRAMES = 3
SEED = 42
K2_MAX_U8 = 2
K2_MAX_FRAC_GT1 = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}; count {torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    report = path.with_suffix(".log")
    used = []
    if report.exists():
        used = [ln.split("ptxas info    :")[-1].strip() for ln in report.read_text().splitlines()
                if "Used" in ln or "spill" in ln]
    log(f"build: {path.name} in {seconds:.2f} s; ptxas: {' | '.join(used)}")


def make_scene(name: str):
    n, width, height, target, frames = SCENES[name]
    config = RenderConfig(width=width, height=height, capacity_pow_two=False)
    table = synthetic.procedural_cloud_table(n, seed=SEED, opacity_mode="capture")
    cam = Camera(config.aspect)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(math.pi, 0.0)
    return table, config, cam, target, frames


def scaled(table: GaussianTable, mult: float) -> GaussianTable:
    return dataclasses.replace(table, scale=table.scale * float(np.float32(mult)))


def calibrate(table: GaussianTable, cam: Camera, config: RenderConfig, target: int):
    """Bisect a scale multiplier until the live element count is within 3%
    of the target (the JAX benchmark's loop, bench.py:104-156)."""
    view, proj = cam.matrices()
    capacity = config.sort_capacity(table.num_gaussians)

    def count(mult):
        c = keygen.count_live_elements(scaled(table, mult), view, proj, cam.position, config)
        return int(torch.clamp(c, max=capacity))

    lo, hi = 0.05, 20.0
    mult = 1.0
    for _ in range(12):
        mult = math.sqrt(lo * hi)
        c = count(mult)
        if abs(c - target) / target < 0.03:
            break
        if c < target:
            lo = mult
        else:
            hi = mult
    live = count(mult)
    if abs(live - target) / target >= 0.03:
        raise RuntimeError(f"calibration missed: {live} live vs target {target}")
    return mult, live


class Capture:
    """Records the arguments the main path hands each kernel wrapper."""

    def __init__(self):
        self.args = {}
        self._saved = []

    def __enter__(self):
        for mod, attr in ((expand_kernel, "expand_rows"), (blend_kernel, "blend_rows")):
            real = getattr(mod, attr)

            def spy(*a, _real=real, _attr=attr, **k):
                self.args[_attr] = (a, k)
                return _real(*a, **k)

            self._saved.append((mod, attr, real))
            setattr(mod, attr, spy)
        return self

    def __exit__(self, *exc):
        for mod, attr, real in self._saved:
            setattr(mod, attr, real)


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of `fn` over `iters` back-to-back runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_image(img: torch.Tensor, config: RenderConfig, what: str) -> None:
    if tuple(img.shape) != (config.height, config.width, 3):
        raise RuntimeError(f"{what}: image shape {tuple(img.shape)}")
    if not torch.isfinite(img).all():
        raise RuntimeError(f"{what}: non-finite pixels")
    for ch in range(3):
        if not img[..., ch].mean() > 0:
            raise RuntimeError(f"{what}: channel {ch} is empty")


def u8_compare(a: torch.Tensor, b: torch.Tensor):
    """Per channel (max |Δ|, share of |Δ| > 1) of the 8-bit quantized images."""
    qa = torch.round(a * 255.0).to(torch.int32)
    qb = torch.round(b * 255.0).to(torch.int32)
    d = (qa - qb).abs()
    return [(int(d[..., c].max()), float((d[..., c] > 1).float().mean())) for c in range(3)]


def phase_fixtures() -> None:
    """Small fixture scenes: the card's frame against the CPU plain frame."""
    config = RenderConfig(width=192, height=96, capacity_slack_per_tile=32)
    for cls in (synthetic.SimpleTestGaussiansScene, synthetic.TestSortScene):
        scene = cls(aspect=config.aspect)
        scene.init()
        scene.camera.set_aspect(config.aspect)
        outs = []
        for device in ("cuda", "cpu"):
            r = Renderer(config, device=device)
            r.init_for_scene(scene.gaussians())
            outs.append(r.draw(scene.camera))
        gpu, cpu = outs
        if int(gpu.num_elements) != int(cpu.num_elements):
            raise RuntimeError(f"{cls.__name__}: element counts differ")
        d = (gpu.image_u8.cpu().to(torch.int32) - cpu.image_u8.to(torch.int32)).abs()
        if int(d.max()) > 1:
            raise RuntimeError(f"{cls.__name__}: card vs CPU 8-bit max |Δ| {int(d.max())}")
        check_image(gpu.image, config, cls.__name__)
        log(f"fixture: {cls.__name__} {int(gpu.num_elements)} elements, card vs CPU "
            f"8-bit max |Δ| {int(d.max())}")


def run_scene(name: str):
    table, config, cam, target, frames = make_scene(name)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    mult, live = calibrate(table.to(dev), cam, config, target)
    calib_s = time.perf_counter() - t0
    renderer = Renderer(config, device=dev)
    renderer.init_for_scene(scaled(table, mult))
    base = cam.position.copy()

    for counter in (expand_kernel, blend_kernel):
        counter.LAUNCHES = 0
    timer = CudaPassTimer()
    frame_ms = []
    with Capture() as cap:
        for i in range(WARMUP_FRAMES + frames):
            cam.set_position(base + np.float32([1e-3 * i, 0.0, 0.0]))
            t = timer if i >= WARMUP_FRAMES else None
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = renderer.draw(cam, timer=t)
            end.record()
            if t is not None:
                frame_ms.append((start, end))
        torch.cuda.synchronize()
    launches = {"expand_rows": expand_kernel.LAUNCHES, "blend_tiles": blend_kernel.LAUNCHES}
    if min(launches.values()) == 0:
        raise RuntimeError(f"{name}: a kernel of the path was not launched: {launches}")
    frame_ms = [s.elapsed_time(e) for s, e in frame_ms]
    passes = timer.summary()
    check_image(out.image, config, name)
    if int(out.num_elements) <= 0:
        raise RuntimeError(f"{name}: no live elements")
    log(f"scene {name}: {table.num_gaussians} gaussians, capacity "
        f"{renderer.capacity}, scale x{mult:.4f} -> {live} live (target {target}, "
        f"calibrated in {calib_s:.1f} s); last frame {int(out.num_elements)} elements; "
        f"ms/frame median {statistics.median(frame_ms):.3f} "
        f"(min {min(frame_ms):.3f}, max {max(frame_ms):.3f}, {frames} frames); per pass ms "
        + ", ".join(f"{k} {passes[k]:.3f}" for k in ("keygen", "expand", "sort", "ranges", "blend"))
        + f"; launches {launches}")
    return renderer, cam, cap.args, launches


def check_elements_vs_cpu(renderer: Renderer, cam: Camera) -> None:
    """keygen + sort + ranges of the last frame: card == CPU, bit for bit."""
    view, proj = cam.matrices()
    results = []
    for table in (renderer.table, renderer.table.to("cpu")):
        el, _ = keygen.generate_sort_elements(
            table, view, proj, cam.position, renderer.config, renderer.capacity,
            use_kernels=table.device.type == "cuda",
        )
        el = sort.sort_elements(el, renderer.config)
        results.append((el, ranges.find_ranges(el, renderer.config.num_tiles)))
    (ge, gr), (ce, cr) = results
    bad = {k: int((getattr(ge, k).cpu() != getattr(ce, k)).sum())
           for k in ("tile", "depth", "index")}
    bad["ranges"] = int((gr.cpu() != cr).sum())
    bad["count"] = int(ge.count) - int(ce.count)
    if any(bad.values()):
        raise RuntimeError(f"card vs CPU element mismatch: {bad}")
    log(f"check: keygen/sort/ranges card == CPU bit for bit ({int(ce.count)} elements)")


def check_expand_edge_cases() -> None:
    """The JAX expand tests' cases (tests/test_expand.py:48-92), on the card."""
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 9, size=700)
    counts[rng.random(700) < 0.4] = 0
    long_run = np.ones(3000, np.int64)
    long_run[100:2500] = 0
    cases = [
        (counts, int(counts.sum()) + 300),
        (long_run, 1024),
        (np.full(300, 11), 1536),
        (np.array([5, 0, 3, 0, 0, 2] * 10), 1000),
        (np.zeros(600, np.int64), 512),
        (rng.integers(0, 4000, size=50), 40_000),
    ]
    for counts, capacity in cases:
        n = len(counts)
        cols = torch.from_numpy(np.stack([
            np.arange(n, dtype=np.int32),
            rng.integers(-(2**31), 2**31, size=n).astype(np.int32),
        ])).cuda()
        c = torch.from_numpy(np.asarray(counts, np.int32)).cuda()
        got, total = expand_kernel.expand_rows(cols, c, capacity)
        want, want_total = expand_kernel.expand_rows_plain(cols, c, capacity)
        if not torch.equal(got, want) or int(total) != int(want_total):
            raise RuntimeError(f"expand_rows edge case (n={n}, capacity={capacity}) differs")


def check_kernels(args, config: RenderConfig, name: str) -> dict:
    """Each kernel against its plain version on the frame's own inputs."""
    (cols, counts, capacity), _ = args["expand_rows"]
    got, total = expand_kernel.expand_rows(cols, counts, capacity)
    want, want_total = expand_kernel.expand_rows_plain(cols, counts, capacity)
    live = int(min(int(total), capacity))
    if int(total) != int(want_total) or not torch.equal(got[:, :live], want[:, :live]):
        raise RuntimeError(f"{name}: expand_rows differs from its plain version")
    if got[:, live:].any():
        raise RuntimeError(f"{name}: expand_rows left dead slots non-zero")
    k1 = {
        "max_abs_err": int((got.to(torch.int64) - want.to(torch.int64)).abs().max()),
        "ms": cuda_ms(lambda: expand_kernel.expand_rows(cols, counts, capacity), 20),
        "plain_ms": cuda_ms(lambda: expand_kernel.expand_rows_plain(cols, counts, capacity), 3),
    }

    (table, index, rng_, _cfg), _ = args["blend_rows"]
    img = blend_kernel.blend_rows(table, index, rng_, config)
    ref = blend_ops.blend_rows_plain(table, index, rng_, config)
    check_image(img, config, f"{name} kernel blend")
    check_image(ref, config, f"{name} plain blend")
    per_ch = u8_compare(img, ref)
    for ch, (mx, frac) in enumerate(per_ch):
        if mx > K2_MAX_U8 or frac > K2_MAX_FRAC_GT1:
            raise RuntimeError(f"{name}: blend channel {ch}: 8-bit max |Δ| {mx}, "
                               f"share > 1 {frac:.2e}")
    k2 = {
        "max_abs_err": float((img - ref).abs().max()),
        "u8": per_ch,
        "ms": cuda_ms(lambda: blend_kernel.blend_rows(table, index, rng_, config), 20),
        "plain_ms": cuda_ms(lambda: blend_ops.blend_rows_plain(table, index, rng_, config), 1),
    }
    log(f"check {name}: expand_rows bit-exact ({live} live of {capacity}), kernel "
        f"{k1['ms']:.3f} ms vs plain {k1['plain_ms']:.3f} ms; blend_tiles float max |Δ| "
        f"{k2['max_abs_err']:.3e}, 8-bit (max, share>1) per channel {per_ch}, kernel "
        f"{k2['ms']:.3f} ms vs plain {k2['plain_ms']:.3f} ms")
    return {"expand_rows": k1, "blend_tiles": k2}


def main() -> None:
    kind = phase_device()
    phase_build()
    phase_fixtures()
    check_expand_edge_cases()

    results, launches = {}, {"expand_rows": 0, "blend_tiles": 0}
    for i, name in enumerate(SCENES):
        renderer, cam, args, scene_launches = run_scene(name)
        if i == 0:
            check_elements_vs_cpu(renderer, cam)
        results[name] = check_kernels(args, renderer.config, name)
        for k, v in scene_launches.items():
            launches[k] += v
        del renderer, args
        torch.cuda.empty_cache()
    log(f"launches: {launches} over {len(SCENES)} scenes' frames")

    first = results[next(iter(SCENES))]
    meta = {
        "expand_rows": ("vk3dgaussiansplatting_tpu_torch/csrc/expand.cu",
                        "vk3dgaussiansplatting_tpu/ops/pallas/expand_kernel.py:516"),
        "blend_tiles": ("vk3dgaussiansplatting_tpu_torch/csrc/blend.cu",
                        "vk3dgaussiansplatting_tpu/ops/pallas/blend_kernel.py:760"),
    }
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": src,
            "replaces": rep,
            "launches": launches[k],
            "max_abs_err": max(r[k]["max_abs_err"] for r in results.values()),
            "ms": first[k]["ms"],
            "plain_ms": first[k]["plain_ms"],
        }
        for k, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
