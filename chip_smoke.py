#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vk3dgaussiansplatting_tpu_torch) on one
NVIDIA GPU, through `Renderer` as a user drives it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, one line each (any failure raises, and the exit code is non-zero):

  device   the card's name, and name + power limit from nvidia-smi
  build    the CUDA kernels compiled from csrc/, one nvcc per source, all
           started together (seconds, ptxas report); K7, K8 and the radix
           sort's kernels without a spill or a stack, or the run fails;
           csrc/radix.cu's constants (vk3d_radix_config) equal to
           radix_kernel's copies
  fixture  the fixture scenes on the card (kernels) against the CPU (plain
           versions): element counts equal, 8-bit ±1 per channel
  check    K1 against its plain version bit for bit on edge cases (zero
           counts, a 12,000-slot gaussian, 1.1M zero counts in a row,
           total > E, E % 4 != 0, N = 0); the radix sort five times with
           equal results and against its plain version and the stable
           torch.sort bit for bit on edge cases (a 4096-tile config, count
           0 and E, slots past the count not SENTINEL, sentinels between
           live slots with the permutation, E not a multiple of the
           partition, all-equal keys, all slots in one bin, a live prefix
           ending inside a partition, depth keys near 2^32 - 1, a 49-bit
           key), its input unchanged; then two different lists sorted back
           to back (the second sort's scratch holds the first's look-back
           flags)
  scene    train7k_720p: the benchmark stand-in cloud (559,263 gaussians,
           1280x720, capacity 4,245,663), scale calibrated to 3,487,911 live
           elements ±3% (K7's counts mode); 3 warm-up + 20 timed frames with
           the camera nudged each frame; median ms/frame and per-pass ms from
           CUDA events; K7, K1, K8, the radix sort and K2 launch once a
           frame, the radix sort's kernels (radix_kernel.PASSES) are its
           planned_kernels a sort, no feature table is built, and the
           warm-up frames call no torch.sort or argsort (a
           TorchFunctionMode counts them)
  check    on that scene's last frame: keygen/sort/ranges on the card ==
           on the CPU bit for bit; K1 == its plain version bit for bit; K2
           (blend_tiles on the frame's own GaussianFrameData) vs its plain
           version per channel 8-bit max |Δ| <= 2 with |Δ| > 1 on at most
           1e-4 of pixel-channels; kernel, plain and library times and the
           bound.  K7 keygen_project against project_gaussians_plain on the
           frame's own table, camera and config (train7k also in the other
           two SH modes): counts, the packed int32 rows (depth keys,
           extents), the extents and the visible / keep flags bit for bit;
           each float column of the frame data within 1 ulp on at most 1e-6
           of its values, every differing gaussian checked to be an _fma tie
           of the plain version (`fma_ties`); its counts mode bit for bit;
           K8 decode_slots against decode_slots_plain on K1's columns bit for
           bit; their times, plain times and bounds (K7 316 B a gaussian,
           K8 24 B a live slot + 24 B a slot).  The radix sort on the
           frame's own keygen output five times (equal results) and against
           its plain version and the stable torch.sort it replaced, bit for
           bit, its input unchanged; its time, the plain version's,
           torch.sort's (library_ms), its kernels by kind from the profiler
           (setup, histogram, scatter), the bound (24 B a live slot read +
           24 B a slot written), the passes' floor (`radix_floor_bytes`:
           ~193 B a live slot at 6 passes) and the copy yardstick (copy_ of
           the live slots' [3, n] uint32 records: what one pass must move,
           at the card's attainable rate).  The scatter's phases come from
           `radix_phases`, run by hand (an instrumented build of radix.cu)
  scene    garden30k_1080p: 5,834,784 gaussians at 1920x1080, capacity
           14,190,624, calibrated to 13,098,506 live ±3%; 3 warm-up + 10
           timed frames; the same checks of K1 and K2
  bitonic  each scene through Renderer with sort_algorithm=BITONIC at its
           default power-of-two capacity (train7k 8,388,608 slots, garden
           16,777,216) and calibrated scale: 3 warm-up + 10 timed frames,
           then the same camera path through an AUTO renderer of the same
           capacity; ms/frame and the sort section of both; on the last
           frame's own keygen output the kernel == sort_elements_xla == the
           plain version == the stable torch.sort on the card, bit for bit on
           tile, depth and index, its input unchanged, the planned number of
           kernels a sort (bitonic_kernel.planned_passes), the radix sort
           launched no time on the path; the frame's image_u8 == the AUTO
           frame's bit for bit; the kernel's, plain, torch.sort times (the
           one-liner the AUTO sort replaced, as library_ms), the
           bound (48 B a slot) and the network's floor (its passes x 24 B a
           slot); the kernel by kind from the profiler (fused global
           passes, first sort, merges, last merge); four global distances a
           pass instead of five, bit for bit and timed on the same list;
           ptxas's registers, spills and stack of every bitonic kernel, any
           spill or stack failing the phase
  capped   each scene again through Renderer with blend_depth_cap=384,
           blend_cap_max=4096 (the temporal capped blend), same scales:
           train7k_720p on the monolithic temporal frame (3 warm-up + 20
           timed frames, camera step 1e-3), garden30k_1080p on
           ChainedTemporalPlan at steady_frac 0.51 (14 full-capacity warm-up
           frames, the steady switch, 10 timed frames, camera step 1e-5 as
           in the JAX benchmark); ms/frame, per-pass ms, live elements
           before and after the switch, fast/patch/full frame counts, the ok
           flags, host synchronisations per frame (torch's sync debug mode);
           no capped frame may build a feature table (pack_feature_table),
           the radix sort launches once a timed frame with its planned
           kernels a sort, and the warm-up
           frames (the steady switch included) call no torch.sort
  check    on each capped scene's last frame: K3 (reading the frame data by
           id) against its plain version on pack_feature_table's rows, image
           and T bit for bit (the tiles' validity and the next caps,
           thresholds and floors from either T must be equal); K5
           compact_slabs on the layout's call and on a patch pass's (the
           frame's longest patchable tiles marked invalid) bit for bit on
           every lane with its plain version and with the parent's layout
           code (the unmasked K5, the K1 chunk map and the mask), and the
           layout's gid; the unmasked compact_runs and K6 (on the slabs'
           chunk offsets, with its kernel's profiler time) on every lane,
           K1' (garden) bit-exact; K7 and K8 as above on garden's
           prefiltered frame, with its live thresholds; the radix sort on
           the last frame's list as above; the capped
           image against the uncapped K2 frame of the same camera within
           ±1 8-bit on r, g and b; ok true on the last timed frame
  app      the app path at garden30k_1080p's size and calibrated scale:
           write_gaussian_ply (~1.38 GB, a temporary directory), then
           load_gaussians through the native parser (ply_load_s, the
           parser from its log line), its table bit for bit with the numpy
           parser's; the CLI on the card (--ply, 1920x1080, 3 frames, --out:
           K7, K1, K8, the radix sort and K2 once a frame, the sort's
           planned kernels each time), its PNG read
           back with the port's
           read_png bit for bit with Renderer.draw on the same table and
           camera; the CLI again with --sort bitonic, its PNG bit for bit
           with the first (the bitonic kernel once a frame, the radix sort
           never); the .ply fixture rendered as tests/test_ply_fixture.py
           does, within ±1 8-bit of tests/golden/ply_fixture.png
  motion   garden's chained plan for 10 more frames at camera step 1e-3,
           recorded (mode, live, ok, unfixable tiles), not checked
  dist     the distributed depth-banded frame (parallel/dist.py) at
           garden30k_1080p, full width, same scale: world 4 on gloo, the four
           ranks sharing the one card (each a spawned process that rebuilds
           the table from the seed and takes its shard; the exchange is
           copied through host memory, not NCCL), 1 warm-up + 3 timed
           frames; then world 1 on NCCL, 1 warm-up + 1 timed frame.  Per
           rank: ms/frame and per-pass ms (keygen, bucket, exchange, sort,
           ranges, blend), [live, sent, received, dropped].  Checked: sent
           == live on every rank, sum received == sum sent, no strip-window
           drops, max received <= 3 x min received; K4 against its plain
           version on every phase of every rank's last frame
           (`blend_kernel.strip_mismatch`: colour bit for bit; K4 stops
           each pixel at T < stop, so log T bit for bit where the plain
           T >= stop, both T below the stop elsewhere); the radix sort
           (_sort3's, every slot, with the permutation) once a frame on
           every rank with its planned kernels (no setup), on each rank's last received list against its
           plain version and the stable torch.sort bit for bit; the
           assembled image within ±1 8-bit per channel of the uncapped
           single-device frame of the same camera
  launches each path's kernels launched during its frames (counts set to 0
           just before the path, read just after; the distributed path's
           summed over ranks); K6, which no path runs, reports 0 path
           launches, and its check-phase comparison calls apart
           ("check_launches", "on_path": false)

Each kernel's bound is the larger of its bytes over 3.35 TB/s (each input
read once, each output written once, at this run's shapes) and its float32
operations over 67 TFLOP/s; for the blends the work is what the inputs need
(`blend_work`: P, each pixel's pairs up to its saturating element, for K2
and K4; P_batch, every pair of every batch a tile enters, for K3, whose
batch-granular T the capped policy reads; both are logged), counted by
kind: every pair evaluated, an eligible pair's T step, and the colour an
eligible pair adds only while its pixel's T is at or above the stop.

Then one JSON line with each kernel's launches, error, times (kernel,
plain, one PyTorch call where one computes the same function), bound and
launches per frame on each path, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import linecache
import logging
import math
import os
import re
import statistics
import subprocess
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as tdist

from vk3dgaussiansplatting_tpu_torch.app import cli
from vk3dgaussiansplatting_tpu_torch.core.config import (
    SENTINEL, RenderConfig, SortAlgorithm, SphericalHarmonicsMode,
)
from vk3dgaussiansplatting_tpu_torch.io import image as image_io
from vk3dgaussiansplatting_tpu_torch.io import ply
from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable, from_raw_ply_columns
from vk3dgaussiansplatting_tpu_torch.ops import bitonic as bitonic_ops
from vk3dgaussiansplatting_tpu_torch.ops import blend as blend_ops
from vk3dgaussiansplatting_tpu_torch.ops import capped as capped_ops
from vk3dgaussiansplatting_tpu_torch.ops import keygen, ranges, sort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import (
    _build, bitonic_kernel, blend_kernel, compact_kernel, expand_kernel, keygen_kernel,
    radix_kernel,
)
from vk3dgaussiansplatting_tpu_torch.parallel import dist, mesh, multihost
from vk3dgaussiansplatting_tpu_torch.pipeline import Renderer, render_frame
from vk3dgaussiansplatting_tpu_torch.render import project
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
# The capped phases: the JAX benchmark's capped settings (bench.py:171-184).
CAP, CAP_MAX, STEADY_FRAC = 384, 4096, 0.51
SYNC_FRAMES = 2  # frames run under torch's sync debug mode, before timing
BITONIC_FRAMES = 10  # timed frames a scene of the bitonic phase
# Camera step per capped frame (x, world units).  garden's prefilter steady
# set is driven at the JAX benchmark's step (bench.py:705-787, i * 1e-5):
# at 1e-3 (~0.5 px a frame) tens of prefiltered tiles a frame fail
# validation by design, the filtered list outgrows the 0.51 steady capacity
# and the switch is declined (PERF.md, Findings), which `probe_motion` measures.
CAPPED_NUDGE = {"train7k_720p": 1e-3, "garden30k_1080p": 1e-5}
MOTION_PROBE = (10, 1e-3)  # frames and step of garden's motion probe
# The distributed phase: (backend, world, warm-up frames, timed frames) per
# run.  Four gloo ranks share the one card (NCCL refuses two ranks on one
# GPU); world 1 on NCCL covers NCCL's code path.  Frame i of a run draws the
# camera at step DIST_LAST_STEP - (frames - 1 - i) of DIST_NUDGE in x, so
# every run ends at the camera of the single-device reference frame.
DIST_SCENE = "garden30k_1080p"
DIST_RUNS = (("gloo", 4, 1, 3), ("nccl", 1, 1, 1))
DIST_NUDGE = 1e-3
DIST_LAST_STEP = 3
DIST_PASSES = ("keygen", "bucket", "exchange", "sort", "ranges", "blend")
# Published peaks of one H100 SXM (NVIDIA's data sheet), for each kernel's
# bound: the larger of its bytes over the memory rate and its operations
# over the float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# Float32 operations (a multiply-add counts 2, as in the peak rate) of a
# blend, by kind.  Every (pixel, element) pair evaluated: dx, dy (2), f =
# a dx dx + c dy dy + b dx dy (8) and the two eligibility tests, f <= 0 and
# f >= thr (2).  An eligible pair also steps T: alpha = galpha exp(f),
# 1 - alpha and the product (3); and, while its pixel's T is at or above
# the stop, adds colour: T alpha and three multiply-adds (7).  expf's own
# instructions are not counted, so the bound stays a lower bound.
FLOPS_PER_PAIR = 12
FLOPS_PER_T_STEP = 3
FLOPS_PER_COLOUR = 7
# Bytes of one gaussian's row as K2 and K3 read it (screen_pos 8, cov_inv
# 12, color_alpha 16), and of a pack_feature_table row (K4).
FRAME_ROW_BYTES = 36
TABLE_ROW_BYTES = 40
# K7 keygen_project, a gaussian: the table row it reads (position 12, scale
# 12, rot 16, opacity 4, the SH row 192), and what the wrapper writes (the
# count 8, the six int32 column rows 24, the frame data 48); in the counts
# mode it reads position, scale and rot and writes the count.  Its float32
# operations (a multiply-add counts 2), as csrc/keygen.cu writes them: view
# transform 18, NDC 14, depth 3, rotation 54, R S 9, W R S 45, the Jacobian
# 13, J A 18, covariance 17, screen 6, extents 21, direction 12, SH basis
# 30, SH dot 96, colour 6, inverse 4.
KEYGEN_READ_BYTES = 236
KEYGEN_WRITE_BYTES = 80
KEYGEN_COUNT_BYTES = 48
KEYGEN_FLOPS = 366
# K7's floats against its plain version: at most 1 ulp apart, on at most
# this share of a column's values, each at an _fma tie of the plain version.
KEYGEN_MAX_ULP = 1
KEYGEN_MAX_FRAC = 1e-6

# Launch counters of the kernel wrappers.
COUNTERS = {
    "expand_rows": (expand_kernel, "LAUNCHES"),
    "expand_rows_streamed": (expand_kernel, "STREAMED_LAUNCHES"),
    "blend_tiles": (blend_kernel, "LAUNCHES"),
    "blend_flat": (blend_kernel, "FLAT_LAUNCHES"),
    "compact_slabs": (compact_kernel, "SLABS_LAUNCHES"),
    "compact_runs": (compact_kernel, "RUNS_LAUNCHES"),
    "compact_segments": (compact_kernel, "SEGMENTS_LAUNCHES"),
    "blend_strip": (blend_kernel, "STRIP_LAUNCHES"),
    "bitonic_sort": (bitonic_kernel, "LAUNCHES"),
    "keygen_project": (keygen_kernel, "LAUNCHES"),
    # K7 in its counts mode (count_live_elements): the steady switch's probe.
    "keygen_count": (keygen_kernel, "COUNT_LAUNCHES"),
    "decode_slots": (keygen_kernel, "DECODE_LAUNCHES"),
    "radix_sort": (radix_kernel, "LAUNCHES"),
}


# The kernels the sorts' launches ran (their wrappers' PASSES).
KERNEL_COUNTERS = {"bitonic_sort": bitonic_kernel, "radix_sort": radix_kernel}


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)
    for mod in KERNEL_COUNTERS.values():
        mod.PASSES = 0


def read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


def read_kernels() -> dict:
    return {k: mod.PASSES for k, mod in KERNEL_COUNTERS.items()}


def call_plan(call) -> tuple[int, bool]:
    """(num_tiles, counted) of a captured radix_sort call."""
    (_tile, _depth, _index, count, num_tiles), _kw = call
    return num_tiles, count is not None


def check_radix_kernels(what: str, plan: tuple[int, bool], sorts: int, kernels: int) -> float:
    """The radix sort's kernels on a path, `kernels` over `sorts` launches,
    against its plan (radix_kernel.planned_kernels for `plan`, the
    num_tiles and whether a count bounds the sort).  Returns the kernels a
    sort."""
    planned = radix_kernel.planned_kernels(*plan)
    if not sorts or kernels != sorts * planned:
        raise RuntimeError(f"{what}: {sorts} radix sorts launched {kernels} kernels, "
                           f"not {planned} a sort")
    return kernels / sorts


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


def ptxas_report() -> list[list[str]]:
    """ptxas's report of the built library, one entry a kernel: its name
    with its template arguments, then its registers, shared memory, stack
    and spills."""
    report = _build.library_path().with_suffix(".log")
    entries = []
    for ln in report.read_text().splitlines() if report.exists() else []:
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            k = re.search(r"([a-z][a-z_]*_kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            if not k:
                entries.append([m.group(1)])
                continue
            args = re.findall(r"L([ib])(\d+)E", k.group(2) or "")
            targs = [v if t == "i" else ("true" if v == "1" else "false") for t, v in args]
            entries.append([k.group(1) + (f"<{', '.join(targs)}>" if targs else "")])
        elif entries and ("Used" in ln or "spill" in ln):
            entries[-1].append(ln.split("ptxas info    :")[-1].strip())
    return entries


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    log(f"build: {path.name} in {seconds:.2f} s; ptxas: "
        f"{' | '.join(' '.join(e) for e in ptxas_report())}")


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
    """Records the arguments the main path hands each kernel wrapper (and
    the capped blend's finish phase, and the feature-table build):
    `args[name]` is the last call, `calls[name]` every call since
    `new_frame()`, `counts[name]` the calls since the capture began."""

    TARGETS = (
        (expand_kernel, "expand_rows"),
        (expand_kernel, "expand_rows_streamed"),
        (blend_kernel, "blend_tiles"),
        (blend_kernel, "pack_feature_table"),
        (blend_kernel, "blend_flat"),
        (blend_kernel, "blend_strip"),
        (compact_kernel, "compact_slabs"),
        (capped_ops, "capped_finish"),
        (bitonic_ops, "sort_elements_bitonic"),
        (keygen_kernel, "project_gaussians"),
        (keygen_kernel, "decode_slots"),
        (radix_kernel, "radix_sort"),
    )

    def __init__(self):
        self.args = {}
        self.calls = {}
        self.counts = {}
        self._saved = []

    def new_frame(self) -> None:
        self.calls = {}

    def __enter__(self):
        for mod, attr in self.TARGETS:
            real = getattr(mod, attr)

            def spy(*a, _real=real, _attr=attr, **k):
                self.args[_attr] = (a, k)
                self.calls.setdefault(_attr, []).append((a, k))
                self.counts[_attr] = self.counts.get(_attr, 0) + 1
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


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(ops)}


def expand_bound(cols: torch.Tensor, counts: torch.Tensor, capacity: int) -> dict:
    """K1's bound: the counts read, the column values of the rows that own
    a live slot read once, the [C, E] output and the total written."""
    c64 = counts.to(torch.int64)
    starts = torch.cumsum(c64, 0) - c64
    owning = int(((c64 > 0) & (starts < capacity)).sum())
    ncols, n = cols.shape
    return bound(4 * ncols * owning + counts.element_size() * n + 4 * ncols * capacity + 8, 0)


def blend_work(rows, index, ranges, config: RenderConfig, *, in_image: bool, tile_base=0,
               trans=None, gather=True):
    """What a blend of these inputs must do at least, counted on the
    frame's own inputs with a rank-stepped loop in the style of
    ops/blend.py:blend_rows_plain: each pixel's (pixel, element) pairs up to
    and including its saturating element (T < stop), or to its range's end.
    A pixel whose incoming T is below the stop needs none; with `in_image`,
    pixels outside the image need none (K2 writes only the image).

    Returns {"pairs": P, "eligible": the eligible pairs among them, "ops":
    their float32 operations (every pair evaluated, an eligible one also
    steps T and adds colour), "slots": slots read, per tile up to its last
    needed element, "rows": distinct gaussian ids among those slots,
    "warp_steps": the sum over 32-pixel warps of their longest pixel's
    pairs (what a warp per 32 pixels must step through), "longest": the
    most slots one tile needs, "pairs_batch": P_batch, the pairs the TPU
    kernels' batch-granular T must evaluate (256 a slot, for each tile's
    slots up to the end of the batch at whose start every pixel is below
    the stop: K3 with T), "eligible_past": the eligible pairs among
    P_batch - P, "ops_batch": "ops" plus P_batch - P pairs evaluated, whose
    eligible ones step T and add no colour, "slots_batch" and "rows_batch"
    likewise}."""
    device = rows.device
    ts = config.tile_size
    p = ts * ts
    stop, cutoff = config.transmittance_stop, config.alpha_cutoff
    num_tiles = ranges.shape[0]
    e = index.shape[0]
    tiles = tile_base + torch.arange(num_tiles, device=device)
    pix = torch.arange(p, device=device)
    px_i = (tiles % config.grid_width)[:, None] * ts + pix % ts
    py_i = (tiles // config.grid_width)[:, None] * ts + pix // ts
    px, py = px_i.float(), py_i.float()
    start = ranges[:, 0]
    length = torch.clamp(ranges[:, 1] - start, min=0)
    trans = torch.ones((num_tiles, p), device=device) if trans is None else trans.clone()
    done = trans < stop
    if in_image:
        done |= (px_i >= config.width) | (py_i >= config.height)
    pairs = torch.zeros((num_tiles, p), dtype=torch.int64, device=device)
    # Eligible pairs among P, and among the pairs past each pixel's stop
    # that a batch-granular T still evaluates.
    eligible = torch.zeros(num_tiles, dtype=torch.int64, device=device)
    eligible_past = torch.zeros(num_tiles, dtype=torch.int64, device=device)
    # Batch-granular: a tile stops at the first batch start (its first slot
    # included) at which every pixel is below the stop; batches of
    # blend_batch_k slots from floor(start/128)*128.
    lead = start - torch.div(start, blend_ops.ALIGN_K, rounding_mode="floor") * blend_ops.ALIGN_K
    bk = config.blend_batch_k

    # Slots each tile evaluates with batch-granular T: its range, cut at
    # the batch end once every pixel is below the stop (0 if all start so).
    per_tile_batch = torch.where(done.all(dim=1), 0, length)
    for r in range(int(per_tile_batch.max()) if num_tiles else 0):
        act = torch.nonzero(r < per_tile_batch).squeeze(1)
        if act.numel() == 0:
            break
        kk = start[act] + r
        idx = index[torch.clamp(kk, max=e - 1)]
        live = (kk < e) & (idx != SENTINEL)
        if gather:
            row = rows[torch.where(live, idx, 0)]
        else:
            row = torch.where(live[:, None], rows[torch.clamp(kk, max=e - 1)], 0.0)
        gx, gy, a, b, c = (row[:, j : j + 1] for j in range(5))
        galpha = torch.where(live, row[:, 9], 0.0)[:, None]
        dx = gx - px[act]
        dy = py[act] - gy
        f = (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = galpha * torch.exp(f)
        todo = ~done[act]
        elig = (f <= 0.0) & (alpha >= cutoff)
        pairs[act] += todo.to(torch.int64)
        eligible[act] += (elig & todo).sum(dim=1)
        eligible_past[act] += (elig & ~todo).sum(dim=1)
        t_act = trans[act]
        t_new = torch.where(elig & todo, t_act * (1.0 - alpha), t_act)
        trans[act] = t_new
        was_done = done[act].all(dim=1)
        done[act] |= t_new < stop
        now = act[done[act].all(dim=1) & ~was_done]
        nxt = torch.div(lead[now] + r + bk, bk, rounding_mode="floor") * bk - lead[now]
        per_tile_batch[now] = torch.minimum(per_tile_batch[now], nxt)

    def distinct_rows(per_tile):
        n = int(per_tile.sum())
        slot = torch.repeat_interleave(start, per_tile) + torch.arange(n, device=device) - (
            torch.repeat_interleave(torch.cumsum(per_tile, 0) - per_tile, per_tile))
        ids = index[torch.clamp(slot, max=e - 1)]
        return int(torch.unique(ids[(slot < e) & (ids != SENTINEL)]).numel())

    per_tile = pairs.amax(dim=1)
    n_pairs, n_eligible = int(pairs.sum()), int(eligible.sum())
    n_batch = p * int(per_tile_batch.sum())
    ops = FLOPS_PER_PAIR * n_pairs + (FLOPS_PER_T_STEP + FLOPS_PER_COLOUR) * n_eligible
    return {"pairs": n_pairs, "eligible": n_eligible, "ops": ops, "slots": int(per_tile.sum()),
            "rows": distinct_rows(per_tile),
            "warp_steps": int(pairs.reshape(num_tiles, p // 32, 32).amax(dim=2).sum()),
            "longest": int(per_tile.max()) if num_tiles else 0,
            "pairs_batch": n_batch, "eligible_past": int(eligible_past.sum()),
            "ops_batch": ops + FLOPS_PER_PAIR * (n_batch - n_pairs)
            + FLOPS_PER_T_STEP * int(eligible_past.sum()),
            "slots_batch": int(per_tile_batch.sum()), "rows_batch": distinct_rows(per_tile_batch)}


def _profile(fn, iters: int):
    """torch.profiler's CUDA kernels over `iters` calls of `fn` after one
    warm-up: (name, device ms summed, launches) of each kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages() if ev.self_device_time_total > 0]


def _per_call(ms: float, launches: int, iters: int) -> tuple[float, int]:
    """Device ms and launches a call: the mean launch times the launches a
    call (the profiler can miss the window's first launch or two)."""
    n = max(1, round(launches / iters))
    return round(ms / launches * n, 4), n


def device_breakdown(fn, iters: int = 10) -> dict:
    """Device ms per call of each kernel that `fn` launches, from
    torch.profiler's CUDA activity."""
    return {key[:60]: _per_call(ms, n, iters)[0] for key, ms, n in _profile(fn, iters)}


def device_kinds(fn, kinds: dict, iters: int = 3) -> dict:
    """Device ms and kernel launches per call of `fn`, summed by kind: each
    profiled kernel goes to the first kind whose pattern its name matches
    (`kinds`: kind -> regular expression), "other" if none does."""
    out = {}
    for key, ms, n in _profile(fn, iters):
        kind = next((k for k, pat in kinds.items() if re.search(pat, key)), "other")
        total, count = out.get(kind, (0.0, 0))
        out[kind] = (total + ms, count + n)
    return {k: dict(zip(("ms", "kernels"), _per_call(ms, n, iters))) for k, (ms, n) in out.items()}


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


# The kernels the uncapped frame launches once each; the bitonic path's.
UNCAPPED_PATH = ("keygen_project", "expand_rows", "decode_slots", "radix_sort", "blend_tiles")
BITONIC_PATH = tuple(k for k in UNCAPPED_PATH if k != "radix_sort") + ("bitonic_sort",)


class SortCalls(torch.overrides.TorchFunctionMode):
    """Counts the torch.sort and argsort calls made while it is active."""

    SORTS = (torch.sort, torch.Tensor.sort, torch.argsort, torch.Tensor.argsort, torch.msort)

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.SORTS:
            self.calls += 1
        return func(*args, **(kwargs or {}))


def run_scene(name: str):
    table, config, cam, target, frames = make_scene(name)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    mult, live = calibrate(table.to(dev), cam, config, target)
    calib_s = time.perf_counter() - t0
    renderer = Renderer(config, device=dev)
    renderer.init_for_scene(scaled(table, mult))
    base = cam.position.copy()

    reset_counts()
    timer = CudaPassTimer()
    frame_ms = []
    sorts = SortCalls()
    with Capture() as cap:
        for i in range(WARMUP_FRAMES + frames):
            cap.new_frame()
            cam.set_position(base + np.float32([1e-3 * i, 0.0, 0.0]))
            t = timer if i >= WARMUP_FRAMES else None
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            # The warm-up frames under the sort counter (it costs host time).
            with sorts if t is None else contextlib.nullcontext():
                out = renderer.draw(cam, timer=t)
            end.record()
            if t is not None:
                frame_ms.append((start, end))
        torch.cuda.synchronize()
    drawn = WARMUP_FRAMES + frames
    counts = read_counts()
    launches = {k: v for k, v in counts.items() if k in UNCAPPED_PATH}
    radix_kernels = check_radix_kernels(name, call_plan(cap.args["radix_sort"]),
                                        counts["radix_sort"], read_kernels()["radix_sort"])
    if any(v != drawn for v in launches.values()):
        raise RuntimeError(f"{name}: K7, K1, K8, the radix sort and K2 must launch once a frame, "
                           f"{drawn} frames: {launches}")
    if sorts.calls:
        raise RuntimeError(f"{name}: {sorts.calls} torch.sort/argsort calls in "
                           f"{WARMUP_FRAMES} uncapped frames")
    tables = cap.counts.get("pack_feature_table", 0)
    if tables:
        raise RuntimeError(f"{name}: the uncapped frame built {tables} feature tables")
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
        + f"; launches {launches}, {radix_kernels:g} kernels a radix sort; feature tables built "
        f"{tables}; torch.sort/argsort calls in the {WARMUP_FRAMES} warm-up frames {sorts.calls}")
    per_frame = {k: v / drawn for k, v in counts.items()}
    return renderer, cam, cap.args, launches, mult, per_frame, passes, radix_kernels


def check_elements_vs_cpu(renderer: Renderer, cam: Camera) -> None:
    """keygen + sort + ranges of the last frame: card == CPU, bit for bit."""
    view, proj = cam.matrices()
    results = []
    for table in (renderer.table, renderer.table.to("cpu")):
        el, _ = keygen.generate_sort_elements(
            table, view, proj, cam.position, renderer.config, renderer.capacity,
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
    huge = np.zeros(2000, np.int64)
    huge[[3, 1000]] = [12_000, 5]  # a gaussian of >= 10,000 slots spans many blocks
    sparse = np.zeros(1_100_000, np.int64)  # a run of >= 1,000,000 zero counts
    sparse[[0, 1_099_999]] = [3, 4]
    cases = [
        (counts, int(counts.sum()) + 300),
        (long_run, 1024),
        (np.full(300, 11), 1536),
        (np.array([5, 0, 3, 0, 0, 2] * 10), 1000),
        (np.zeros(600, np.int64), 512),
        (rng.integers(0, 4000, size=50), 40_000),
        (huge, 12_005),
        (huge, 10_001),  # E % 4 != 0, cut inside the long run
        (sparse, 9),
        (sparse, 1027),  # E % 4 != 0 with a dead tail
        (np.zeros(0, np.int64), 64),  # N = 0
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
    log(f"check: expand_rows bit-exact on {len(cases)} edge cases (a 12,000-slot gaussian, "
        f"1.1M zero counts, E % 4 != 0, total > E, N = 0)")


def torch_sort_elements(el, num_tiles: int, with_perm: bool = False):
    """The stable int64-key torch.sort that the AUTO sort replaced: the
    radix sort's library yardstick (library_ms) and a reference here; no
    module of the port calls it."""
    tile = torch.where(el.tile == SENTINEL, num_tiles, el.tile)
    key, perm = torch.sort((tile << 32) | el.depth, stable=True)
    t = key >> 32
    out = keygen.SortElements(torch.where(t == num_tiles, SENTINEL, t), key & 0xFFFFFFFF,
                              el.index[perm], el.count)
    return (out, perm) if with_perm else out


def radix_floor_bytes(n: int, e: int, num_tiles: int, counted: bool, with_perm: bool) -> int:
    """The bytes csrc/radix.cu's kernels move for n sorted slots of e: the
    setup reads and writes the tail's three columns (and its permutation);
    the histogram reads the int64 depth and tile of the prefix once and
    zeroes the status words (passes x partitions x 256 x 4 B); a scatter
    reads and writes the 12-byte records (the first reads the int64
    columns, the index only without the permutation; the last writes the
    int64 columns and the permutation, whose index it gathers), and each
    live partition writes its 256 status words twice and reads 1 KB of its
    predecessor's and the 1 KB digit table."""
    passes = len(radix_kernel.schedule(num_tiles))
    parts, live_parts = -(-e // radix_kernel.TILE), -(-n // radix_kernel.TILE)
    tail = (48 + 8 * with_perm) * (e - n) if counted else 0
    hist = 16 * n + 4 * radix_kernel.BINS * passes * parts
    scatter = ((16 if with_perm else 24) + 12) * n + 24 * n * (passes - 2) + 36 * n
    lookback = 4 * 4 * radix_kernel.BINS * passes * live_parts
    return tail + hist + scatter + 16 * n * with_perm + lookback


def copy_yardstick_ms(n: int) -> float:
    """A device copy of n 12-byte records (`copy_` of a [3, n] uint32
    buffer): the card's attainable rate for what one scatter pass must read
    and write."""
    src = torch.empty((3, n), dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    return cuda_ms(lambda: dst.copy_(src), 20)


RADIX_REPEATS = 5


def check_radix(call, what: str, timed: bool = True) -> dict:
    """The radix sort on one call's own inputs, RADIX_REPEATS times with
    equal results (a look-back ordering fault shows as a run that
    differs), against its plain version and the stable torch.sort, bit for
    bit (the permutation too), its input unchanged; with `timed`, its
    times, its floor and bound, and the copy yardstick."""
    (tile, depth, index, count, num_tiles), kw = call
    with_perm = kw.get("with_perm", False)
    el = keygen.SortElements(tile, depth, index, count)
    before = [x.clone() for x in el[:3]]
    kernels = radix_kernel.PASSES
    got = radix_kernel.radix_sort(tile, depth, index, count, num_tiles, with_perm=with_perm)
    kernels = check_radix_kernels(what, call_plan(call), 1, radix_kernel.PASSES - kernels)
    for k in range(1, RADIX_REPEATS):
        again = radix_kernel.radix_sort(tile, depth, index, count, num_tiles, with_perm=with_perm)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{what}: radix_sort run {k} differs from run 0 on the same list")
    del again
    refs = {"plain version": sort.sort_elements_radix_plain(el, num_tiles, with_perm=with_perm),
            "stable torch.sort": torch_sort_elements(el, num_tiles, with_perm)}
    for ref_name, ref in refs.items():
        ref_cols = [*ref[0][:3], ref[1]] if with_perm else list(ref[:3])
        for col, a, b in zip(("tile", "depth", "index", "permutation"), got, ref_cols):
            if not torch.equal(a, b):
                raise RuntimeError(f"{what}: radix_sort differs from the {ref_name} in {col} at "
                                   f"{int((a != b).sum())} of {a.numel()} slots")
    plain = refs["plain version"]
    plain_cols = [*plain[0][:3], plain[1]] if with_perm else list(plain[:3])
    err = max((int((a - b).abs().max()) for a, b in zip(got, plain_cols) if a.numel()), default=0)
    if not all(torch.equal(a, b) for a, b in zip(before, el[:3])):
        raise RuntimeError(f"{what}: radix_sort wrote its input")
    e = tile.shape[0]
    n = e if count is None else min(max(int(count), 0), e)
    res = {"max_abs_err": err, "e": e, "live": n, "with_perm": with_perm}
    if not timed:
        return res
    del refs, plain, plain_cols, got
    passes = len(radix_kernel.schedule(num_tiles))

    def run():
        return radix_kernel.radix_sort(tile, depth, index, count, num_tiles, with_perm=with_perm)

    res.update({
        "ms": cuda_ms(run, 20),
        "plain_ms": cuda_ms(lambda: sort.sort_elements_radix_plain(el, num_tiles,
                                                                   with_perm=with_perm), 1),
        "library_ms": cuda_ms(lambda: torch_sort_elements(el, num_tiles, with_perm), 10),
        "device_ms": device_kinds(run, {"setup": r"radix_setup", "histogram": r"radix_histogram",
                                        "scatter": r"radix_scatter"}),
        "digit_passes": passes,
        # The function: 24 B a live slot read, 24 B a slot written (and the
        # permutation's 8), the count.
        **bound(24 * n + (32 if with_perm else 24) * e + 8, 0),
        "passes_floor_ms": radix_floor_bytes(n, e, num_tiles, count is not None, with_perm)
        / PEAK_BYTES_PER_S * 1e3,
        "copy_ms": copy_yardstick_ms(n),
    })
    scatter = res["device_ms"].get("scatter", {}).get("ms", float("nan"))
    res["scatter_pass_ms"] = scatter / passes
    log(f"check {what} radix: radix_sort x{RADIX_REPEATS} equal, == plain == stable torch.sort "
        f"bit for bit ({n} sorted of {e} slots, {passes} digit passes, {kernels:g} kernels"
        f"{', with the permutation' if with_perm else ''}), its input unchanged; kernel "
        f"{res['ms']:.3f} ms vs plain {res['plain_ms']:.3f} ms, torch.sort "
        f"{res['library_ms']:.3f} ms; by kind {res['device_ms']}; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}, {res['bound_bytes']} B), the passes' floor "
        f"{res['passes_floor_ms']:.4f} ms; yardstick copy_ of [3, {n}] uint32 "
        f"{res['copy_ms']:.4f} ms, a scatter pass {res['scatter_pass_ms']:.4f} ms "
        f"({res['copy_ms'] / res['scatter_pass_ms']:.0%} of the copy's rate)")
    return res


# The scatter's phases as csrc/radix.cu's instrumented build stamps them
# (vk3d_radix_phases): slot pairs of thread 0's clock.
RADIX_PHASES = {"stage": (1, 2), "count and rank": (2, 3), "scans": (3, 4),
                "inverse map": (4, 5), "look-back": (5, 6), "stores": (6, 7)}


def radix_phases(call, what: str) -> list[dict]:
    """The radix sort of one call's inputs through a second library, built
    from csrc/radix.cu alone with -DVK3D_RADIX_PHASES=1 (a measurement run
    by hand; main() does not call it), whose scatter stamps each
    partition's phases: per pass the mean µs of each phase a partition (the
    block's clock over its cycles per ns), the pass's span, the blocks
    resident on average, and bin 0's look-back length.  Its result must
    equal the port's kernel's."""
    (tile, depth, index, count, num_tiles), kw = call
    with_perm = kw.get("with_perm", False)
    lib = ctypes.CDLL(str(_build.build(("-DVK3D_RADIX_PHASES=1",), stems=("radix",))))
    lib.vk3d_radix_sort.argtypes, lib.vk3d_radix_sort.restype = _build.SIGNATURES["vk3d_radix_sort"]
    lib.vk3d_radix_phases.argtypes, lib.vk3d_radix_phases.restype = [ctypes.c_void_p], ctypes.c_int
    e = tile.shape[0]
    out = [torch.empty_like(tile) for _ in range(3 + with_perm)]
    scratch = torch.empty(radix_kernel.scratch_words(e, num_tiles), dtype=torch.int32,
                          device=tile.device)
    launched = ctypes.c_int64(0)
    err = lib.vk3d_radix_sort(
        tile.data_ptr(), depth.data_ptr(), index.data_ptr(),
        None if count is None else count.data_ptr(), e, num_tiles, scratch.data_ptr(),
        *(x.data_ptr() for x in out[:3]), out[3].data_ptr() if with_perm else None,
        ctypes.byref(launched), tile.device.index, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "radix_sort (phases build)")
    want = radix_kernel.radix_sort(tile, depth, index, count, num_tiles, with_perm=with_perm)
    if not all(torch.equal(a, b) for a, b in zip(out, want)):
        raise RuntimeError(f"{what}: the phases build of the radix sort differs from the kernel")
    stamps = np.zeros((radix_kernel.MAX_PASSES, 4096, 10), np.uint64)
    _build.check_launch(lib.vk3d_radix_phases(stamps.ctypes.data), "vk3d_radix_phases")
    n = e if count is None else min(max(int(count), 0), e)
    parts = min(-(-n // radix_kernel.TILE), 4096)
    rows = []
    for q in range(len(radix_kernel.schedule(num_tiles))):
        b = stamps[q, :parts].astype(np.int64)
        ns = b[:, 8] - b[:, 0]
        per_ns = (b[:, 7] - b[:, 1]).sum() / ns.sum()
        span_us = (b[:, 8].max() - b[:, 0].min()) / 1e3
        rows.append({
            "pass": q, "span_us": round(float(span_us), 2),
            "resident": round(float(ns.sum() / 1e3 / span_us), 1),
            "block_us": round(float(ns.mean() / 1e3), 2),
            **{k: round(float((b[:, hi] - b[:, lo]).mean() / per_ns / 1e3), 2)
               for k, (lo, hi) in RADIX_PHASES.items()},
            "look_back_words": round(float(b[1:, 9].mean()), 1),
        })
    log(f"radix phases {what} ({n} sorted, {parts} partitions; instrumented build, µs a "
        f"partition): {rows}")
    return rows


def check_radix_edge_cases() -> None:
    """The radix sort on lists built to hit its edges, against its plain
    version and the stable torch.sort (`check_radix`), then two different
    lists sorted back to back, so that the second sort's scratch (the
    caching allocator's same block) holds the first's look-back flags."""
    rng = np.random.default_rng(9)
    tile_size = radix_kernel.TILE
    top = (1 << 32) - 1

    def keygen_list(num_tiles, e, live, tile=None, depth=None):
        cols = [np.full(e, SENTINEL, np.int64) for _ in range(3)]
        cols[0][:live] = rng.integers(0, num_tiles, live) if tile is None else tile
        cols[1][:live] = rng.integers(0, 1 << 32, live) if depth is None else depth
        cols[2][:live] = np.arange(live)
        return cols

    def interleave(cols, share):
        dead = rng.random(cols[0].shape[0]) < share
        for c in cols:
            c[dead] = SENTINEL
        return cols, int((~dead).sum())

    def on_card(cols, count):
        t = [torch.from_numpy(c).cuda() for c in cols]
        return t, None if count is None else torch.tensor(count, device="cuda")

    e = 3 * tile_size + 5
    one_bin = 5 * tile_size + 3
    inter, inter_live = interleave(keygen_list(8160, 70_001, 70_001), 0.3)
    past, past_live = interleave(keygen_list(8160, 50_000, 50_000), 0.3)
    cases = {  # what: (num_tiles, columns, count or None, with_perm)
        "4096 tiles": (4096, keygen_list(4096, e, 5000), 5000, False),
        "count 0": (8160, keygen_list(8160, 10_000, 0), 0, False),
        "count E": (8160, keygen_list(8160, 20_001, 20_001), 20_001, False),
        "sentinels between live slots, every slot": (8160, inter, None, True),
        "slots past the count not SENTINEL": (8160, past, past_live, False),
        "E = 1": (3600, keygen_list(3600, 1, 1), 1, False),
        "E = the partition": (3600, keygen_list(3600, tile_size, tile_size), tile_size, True),
        "all-equal keys": (8160, keygen_list(8160, e, e - 3, tile=8159, depth=77), e - 3, False),
        "all slots in one bin": (8160, keygen_list(8160, one_bin, one_bin, tile=0, depth=0),
                                 one_bin, True),
        "prefix ends inside a partition": (8160, keygen_list(8160, 4 * tile_size,
                                                             2 * tile_size + 100),
                                           2 * tile_size + 100, False),
        "depth near 2^32 - 1": (3600, keygen_list(3600, e, e,
                                                  depth=rng.integers(top - 40, top + 1, e)),
                                e, False),
        "49-bit key": (70_000, keygen_list(70_000, e, 9000), 9000, False),
    }
    for what, (num_tiles, cols, count, with_perm) in cases.items():
        t, c = on_card(cols, count)
        check_radix(((*t, c, num_tiles), {"with_perm": with_perm}), f"radix edge case {what}",
                    timed=False)
    # Back to back on one stream, the same size, no synchronisation between.
    size = 100 * tile_size + 17
    lists = [on_card(keygen_list(8160, size, live), live) for live in (size - 999, 61 * tile_size)]
    for with_perm in (False, True):
        outs = [radix_kernel.radix_sort(*t, c, 8160, with_perm=with_perm) for t, c in lists]
        for k, ((t, c), got) in enumerate(zip(lists, outs)):
            ref = torch_sort_elements(keygen.SortElements(*t, c), 8160, with_perm=True)
            want = [*ref[0][:3], ref[1]][:len(got)]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"radix back to back: list {k} (with_perm {with_perm}) differs "
                                   f"from the stable torch.sort")
    log(f"check: radix_sort x{RADIX_REPEATS} equal == plain == stable torch.sort bit for bit on "
        f"{len(cases)} edge cases ({', '.join(cases)}; interleaved: {inter_live} live of 70,001), "
        f"inputs unchanged; two {size}-slot lists back to back == torch.sort")


def check_radix_ptxas() -> list[str]:
    """ptxas on the radix sort's kernels (the setup, the histogram, three
    scatter instantiations): no spills and no stack, or the run fails; and
    the kernel's constants against the wrapper's copies."""
    config = radix_kernel.check_kernel_config()
    entries = [" ".join(x) for x in ptxas_report() if x[0].startswith("radix_")]
    if len(entries) != 5:
        raise RuntimeError(f"ptxas reported {len(entries)} radix kernels, not 5: {entries}")
    for entry in entries:
        if re.search(r"[1-9]\d* bytes (stack frame|spill)", entry):
            raise RuntimeError(f"radix kernel spills or uses a stack: {entry}")
    log(f"check: ptxas on the radix kernels, no spill and no stack: {' | '.join(entries)}; "
        f"csrc/radix.cu's constants == radix_kernel's: {config}")
    return entries


def check_kernels(args, config: RenderConfig, name: str, passes: dict) -> dict:
    """Each kernel against its plain version on the frame's own inputs, with
    its bound and the library call's time."""
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
        "library_ms": cuda_ms(lambda: torch.repeat_interleave(cols, counts, dim=1), 10),
        # The wrapper's scan and the partition search, inside "ms".
        "scan_ms": cuda_ms(lambda: torch.cumsum(counts, 0, dtype=torch.int64), 20),
        "device_ms": device_breakdown(lambda: expand_kernel.expand_rows(cols, counts, capacity)),
        **expand_bound(cols, counts, capacity),
    }

    (elements, rng_, frame, _cfg), _ = args["blend_tiles"]
    img = blend_kernel.blend_tiles(elements, rng_, frame, config)
    table = blend_kernel.pack_feature_table(frame)
    ref = blend_ops.blend_rows_plain(table, elements.index, rng_, config)
    check_image(img, config, f"{name} kernel blend")
    check_image(ref, config, f"{name} plain blend")
    per_ch = u8_compare(img, ref)
    for ch, (mx, frac) in enumerate(per_ch):
        if mx > K2_MAX_U8 or frac > K2_MAX_FRAC_GT1:
            raise RuntimeError(f"{name}: blend channel {ch}: 8-bit max |Δ| {mx}, "
                               f"share > 1 {frac:.2e}")
    work = blend_work(table, elements.index, rng_, config, in_image=True)
    k2 = {
        "max_abs_err": float((img - ref).abs().max()),
        "u8": per_ch,
        "ms": cuda_ms(lambda: blend_kernel.blend_tiles(elements, rng_, frame, config), 20),
        "plain_ms": cuda_ms(lambda: blend_ops.blend_rows_plain(
            blend_kernel.pack_feature_table(frame), elements.index, rng_, config), 1),
        "library_ms": None,
        "blend_section_ms": passes["blend"],
        "work": work,
        **bound(8 * work["slots"] + FRAME_ROW_BYTES * work["rows"] + 16 * config.num_tiles
                + 12 * config.width * config.height, work["ops"]),
    }
    log(f"check {name}: expand_rows bit-exact ({live} live of {capacity}), kernel "
        f"{k1['ms']:.3f} ms (its scan {k1['scan_ms']:.3f}) vs plain {k1['plain_ms']:.3f} ms, "
        f"kernels {k1['device_ms']}, repeat_interleave "
        f"{k1['library_ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}, "
        f"{k1['bound_bytes']} B); blend_tiles float max |Δ| {k2['max_abs_err']:.3e}, 8-bit "
        f"(max, share>1) per channel {per_ch}, kernel {k2['ms']:.3f} ms vs plain "
        f"{k2['plain_ms']:.3f} ms, blend section {passes['blend']:.3f} ms, bound "
        f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}, {k2['bound_bytes']} B; {work})")
    return {"expand_rows": k1, "blend_tiles": k2}


def fma_tie(a, b, c) -> torch.Tensor:
    """Where project._fma(a, b, c) rounds twice on a float32 tie: the
    float64 sum a*b + c inexact (TwoSum's error term; the product is exact)
    and exactly halfway between two float32 values."""
    a, b, c = (x.double() for x in (a, b, c))
    prod = a * b
    s = prod + c
    bb = s - prod
    inexact = ((prod - (s - bb)) + (c - bb)) != 0
    f = s.float()
    other = torch.nextafter(f, torch.where(f.double() < s, math.inf, -math.inf).float())
    return inexact & (f.double() != s) & ((s - f.double()).abs() == (other.double() - s).abs())


def fma_ties(call, rows: torch.Tensor) -> torch.Tensor:
    """For each gaussian of `rows`: whether the plain version, run on those
    gaussians alone, rounds an `_fma` twice on a float32 tie (its float64
    sum inexact and exactly halfway between two float32 values), where a
    true fused multiply-add, K7's and XLA's, can round the other way."""
    table, *rest = call
    sub = GaussianTable(*(getattr(table, f.name)[rows] for f in dataclasses.fields(GaussianTable)))
    tie = torch.zeros(rows.numel(), dtype=torch.bool, device=rows.device)
    real = project._fma

    def fma(a, b, c):
        flag = fma_tie(*(torch.as_tensor(x, device=rows.device) for x in (a, b, c)))
        tie.logical_or_(flag.reshape(flag.shape[0], -1).any(1))
        return real(a, b, c)

    project._fma = fma
    try:
        keygen_kernel.project_gaussians_plain(sub, *rest)
    finally:
        project._fma = real
    return tie


def check_projection(call, what: str) -> dict:
    """K7 against its plain version on one call's own inputs: counts, the
    packed rows, extents and the visible / keep flags bit for bit; each
    float column within KEYGEN_MAX_ULP on at most KEYGEN_MAX_FRAC of its
    values, every differing gaussian at an _fma tie (`fma_ties`); the
    counts mode's counts bit for bit."""
    got = keygen_kernel.project_gaussians(*call, with_aux=True)
    want = keygen_kernel.project_gaussians_plain(*call, with_aux=True)
    bad = keygen_kernel.projection_mismatch(got, want)
    ints = {k: bad[k] for k in keygen_kernel.INT_FIELDS if bad[k]}
    if ints:
        raise RuntimeError(f"{what}: keygen_project's integer outputs differ from its plain "
                           f"version: {ints}")
    n = call[0].num_gaussians
    rows = torch.zeros(n, dtype=torch.bool, device=got.counts.device)
    max_abs = 0.0
    for k in keygen_kernel.FLOAT_FIELDS:
        count, ulp = bad[k]
        if ulp > KEYGEN_MAX_ULP or count > KEYGEN_MAX_FRAC * getattr(want, k).numel():
            raise RuntimeError(f"{what}: keygen_project's {k} differs at {count} values, max "
                               f"{ulp} ulp")
        a, b = getattr(got, k), getattr(want, k)
        d = keygen_kernel.ulp_distance(a, b).reshape(n, -1) > 0
        rows |= d.any(1)
        if d.any():
            max_abs = max(max_abs, float((a - b).reshape(n, -1)[d].abs().max()))
    idx = torch.nonzero(rows).squeeze(1)
    if idx.numel():
        ties = fma_ties(call, idx)
        if not bool(ties.all()):
            raise RuntimeError(f"{what}: keygen_project differs by 1 ulp at gaussians "
                               f"{idx[~ties].tolist()[:20]} without an _fma tie")
    counts_call = (*call[:5], None, call[6])
    counts = keygen_kernel.project_gaussians(*counts_call).counts
    if not torch.equal(counts, keygen_kernel.project_gaussians_plain(*counts_call).counts):
        raise RuntimeError(f"{what}: keygen_project's counts mode differs from its plain version")
    return {"mismatch": {k: bad[k] for k in keygen_kernel.FLOAT_FIELDS},
            "tie_gaussians": idx.tolist()[:20], "max_abs_err": max_abs,
            "live": int(got.counts.sum())}


def check_keygen(args, name: str, sh_modes=()) -> dict:
    """K7 and K8 against their plain versions on the frame's own inputs
    (the last frame's table, camera, config and thresholds; K8 on K1's
    columns), K7 also in each SH mode of `sh_modes`; times and bounds."""
    call = args["project_gaussians"][0]
    table, view, proj, cam_pos, config, capacity, thr = call
    n = table.num_gaussians
    k7 = check_projection(call, f"{name} keygen_project")
    modes = {}
    for mode in sh_modes:
        c = (*call[:4], dataclasses.replace(config, sh_mode=mode), *call[5:])
        modes[mode.name] = check_projection(c, f"{name} keygen_project {mode.name}")["mismatch"]
    counts_call = (*call[:5], None, thr)
    k7.update({
        "sh_modes": modes,
        "ms": cuda_ms(lambda: keygen_kernel.project_gaussians(*call), 20),
        "plain_ms": cuda_ms(lambda: keygen_kernel.project_gaussians_plain(*call), 1),
        "library_ms": None,
        "count_ms": cuda_ms(lambda: keygen_kernel.project_gaussians(*counts_call), 20),
        "count_bound_ms": bound(KEYGEN_COUNT_BYTES * n, 0)["bound_ms"],
        "device_ms": device_breakdown(lambda: keygen_kernel.project_gaussians(*call)),
        # The thresholds are read once too, where the prefilter is on.
        **bound((KEYGEN_READ_BYTES + KEYGEN_WRITE_BYTES) * n
                + (8 * thr.numel() if thr is not None else 0), KEYGEN_FLOPS * n),
    })

    (cols, total, grid_w), _ = args["decode_slots"]
    got = keygen_kernel.decode_slots(cols, total, grid_w)
    want = keygen_kernel.decode_slots_plain(cols, total, grid_w)
    for col, a, b in zip(("tile", "depth", "index", "count"), got, want):
        if not torch.equal(a, b):
            raise RuntimeError(f"{name}: decode_slots differs from its plain version in {col} at "
                               f"{int((a != b).sum())} values")
    e = cols.shape[1]
    live = int(want[3])
    k8 = {
        "max_abs_err": 0,
        "ms": cuda_ms(lambda: keygen_kernel.decode_slots(cols, total, grid_w), 20),
        "plain_ms": cuda_ms(lambda: keygen_kernel.decode_slots_plain(cols, total, grid_w), 3),
        "library_ms": None,
        "device_ms": device_breakdown(lambda: keygen_kernel.decode_slots(cols, total, grid_w)),
        # The live slots' six columns and the total read, three int64
        # columns and the count written.
        **bound(24 * live + 24 * e + 16, 0),
    }
    log(f"check {name} keygen: keygen_project == plain on {n} gaussians ({k7['live']} live, "
        f"prefilter {'on' if thr is not None else 'off'}): counts, packed rows, extents, "
        f"visible/keep bit for bit; floats (values differing, max ulp) {k7['mismatch']}, "
        f"max |Δ| {k7['max_abs_err']:.3e}, _fma-tie gaussians {k7['tie_gaussians']}"
        + "".join(f"; {m} {v}" for m, v in modes.items())
        + f"; counts mode == plain; kernel {k7['ms']:.3f} ms vs plain {k7['plain_ms']:.3f} ms, "
        f"counts mode {k7['count_ms']:.3f} ms (bound {k7['count_bound_ms']:.4f}), kernels "
        f"{k7['device_ms']}, bound {k7['bound_ms']:.4f} ms ({k7['bound_by']}, "
        f"{k7['bound_bytes']} B); decode_slots == plain bit for bit ({live} live of {e}), "
        f"{k8['ms']:.3f} ms vs plain {k8['plain_ms']:.3f} ms, kernels {k8['device_ms']}, bound "
        f"{k8['bound_ms']:.4f} ms ({k8['bound_bytes']} B)")
    return {"keygen_project": k7, "decode_slots": k8}


def check_keygen_ptxas() -> list[str]:
    """ptxas on K7 and K8: no spills and no stack, or the run fails."""
    entries = [" ".join(x) for x in ptxas_report()
               if x[0].startswith(("keygen_project_kernel", "decode_slots_kernel"))]
    if len(entries) != 3:
        raise RuntimeError(f"ptxas reported {len(entries)} keygen kernels, not 3: {entries}")
    for entry in entries:
        if re.search(r"[1-9]\d* bytes (stack frame|spill)", entry):
            raise RuntimeError(f"keygen kernel spills or uses a stack: {entry}")
    log(f"check: ptxas on the keygen kernels, no spill and no stack: {' | '.join(entries)}")
    return entries


def timed_draws(renderer: Renderer, cam: Camera, base, frames: int, cap=None):
    """WARMUP_FRAMES + `frames` draws, the camera stepped 1e-3 in x a frame
    from `base`: (last FrameOutputs, ms of each timed frame, per-pass ms)."""
    timer = CudaPassTimer()
    events = []
    for i in range(WARMUP_FRAMES + frames):
        if cap is not None:
            cap.new_frame()
        cam.set_position(base + np.float32([1e-3 * i, 0.0, 0.0]))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = renderer.draw(cam, timer=timer if i >= WARMUP_FRAMES else None)
        end.record()
        if i >= WARMUP_FRAMES:
            events.append((start, end))
    torch.cuda.synchronize()
    return out, [s.elapsed_time(e) for s, e in events], timer.summary()


def run_bitonic(name: str, mult: float):
    """The bitonic tier through Renderer at the scene's default power-of-two
    capacity, then an AUTO renderer of the same capacity on the same camera
    path; the kernel against sort_elements_xla and its plain version on the
    last frame's own keygen output, the two frames' images bit for bit.
    Returns (the kernel's results, the path's launches, its launches a
    frame)."""
    table, _config, cam, _target, _frames = make_scene(name)
    width, height = SCENES[name][1:3]
    config = RenderConfig(width=width, height=height, sort_algorithm=SortAlgorithm.BITONIC)
    renderer = Renderer(config, device="cuda")
    renderer.init_for_scene(scaled(table, mult))
    del table
    e = renderer.capacity
    planned = bitonic_kernel.planned_passes(e)
    base = cam.position.copy()
    reset_counts()
    with Capture() as cap:
        out, frame_ms, passes = timed_draws(renderer, cam, base, BITONIC_FRAMES, cap)
    drawn = WARMUP_FRAMES + BITONIC_FRAMES
    launches = read_counts()
    kernels = read_kernels()
    path = {k: launches[k] for k in BITONIC_PATH}
    if (any(v != drawn for v in path.values()) or kernels["bitonic_sort"] != drawn * planned
            or launches["radix_sort"] or kernels["radix_sort"]):
        raise RuntimeError(f"{name} bitonic: {drawn} frames launched {path}, kernels {kernels} "
                           f"({planned} a bitonic sort planned), radix_sort "
                           f"{launches['radix_sort']}")
    check_image(out.image, config, f"{name} bitonic")

    # The last frame's own keygen output: the kernel against the AUTO sort
    # (the radix kernel), the stable torch.sort and the plain version, bit
    # for bit; its input unchanged.
    (el,), _ = cap.args["sort_elements_bitonic"]
    before = [x.clone() for x in el[:3]]
    got = bitonic_ops.sort_elements_bitonic(el)
    refs = {"sort_elements_xla": sort.sort_elements_xla(el, config.num_tiles),
            "stable torch.sort": torch_sort_elements(el, config.num_tiles),
            "plain version": bitonic_ops.sort_elements_bitonic_plain(el)}
    for ref_name, ref in refs.items():
        for col in ("tile", "depth", "index"):
            a, b = getattr(got, col), getattr(ref, col)
            if not torch.equal(a, b):
                raise RuntimeError(f"{name}: bitonic_sort differs from the {ref_name} in {col} "
                                   f"at {int((a != b).sum())} of {e} slots")
    if not all(torch.equal(a, b) for a, b in zip(before, el[:3])):
        raise RuntimeError(f"{name}: bitonic_sort wrote its input")
    del before

    # ptxas on the kernels: no spills and no stack.
    ptxas = [" ".join(x) for x in ptxas_report() if x[0].startswith("bitonic_")]
    for entry in ptxas:
        if re.search(r"[1-9]\d* bytes (stack frame|spill)", entry):
            raise RuntimeError(f"bitonic kernel spills or uses a stack: {entry}")

    auto = Renderer(dataclasses.replace(config, sort_algorithm=SortAlgorithm.AUTO), device="cuda")
    auto.init_for_scene(renderer.table)
    auto_out, auto_ms, auto_passes = timed_draws(auto, cam, base, BITONIC_FRAMES)
    if auto.capacity != e or not torch.equal(auto_out.image_u8, out.image_u8):
        raise RuntimeError(f"{name}: the bitonic frame differs from the AUTO frame at capacity {e}")
    res = {
        "max_abs_err": max(int((getattr(got, c) - getattr(refs["plain version"], c)).abs().max())
                           for c in ("tile", "depth", "index")),
        "ms": cuda_ms(lambda: bitonic_ops.sort_elements_bitonic(el), 10),
        "plain_ms": cuda_ms(lambda: bitonic_ops.sort_elements_bitonic_plain(el), 1),
        "library_ms": cuda_ms(lambda: torch_sort_elements(el, config.num_tiles), 10),
        # The kernel by kind, from the profiler: ms and kernels a sort.
        "device_ms": device_kinds(lambda: bitonic_ops.sort_elements_bitonic(el), {
            "fused global passes": r"bitonic_global_kernel",
            "first sort": r"bitonic_shared_kernel<true",
            "merges": r"bitonic_shared_kernel<false, false>",
            "last merge": r"bitonic_shared_kernel<false, true>",
        }),
        "kernels_per_sort": planned,
        # The network's own floor: every kernel reads and writes 12 B a slot.
        "network_floor_ms": planned * 24 * e / PEAK_BYTES_PER_S * 1e3,
        **bound(48 * e, 0),
    }
    log(f"bitonic {name}: capacity {e}, last frame {int(out.num_elements)} live; ms/frame median "
        f"{statistics.median(frame_ms):.3f} (min {min(frame_ms):.3f}, max {max(frame_ms):.3f}, "
        f"{BITONIC_FRAMES} frames); per pass ms "
        + ", ".join(f"{k} {passes[k]:.3f}" for k in ("keygen", "expand", "sort", "ranges", "blend"))
        + f"; launches {path}, {kernels['bitonic_sort']} kernels ({planned} a sort, block "
        f"{bitonic_kernel.BLOCK}); the AUTO renderer at the same capacity: ms/frame median "
        f"{statistics.median(auto_ms):.3f} (min {min(auto_ms):.3f}, max {max(auto_ms):.3f}), sort "
        f"{auto_passes['sort']:.3f}")
    log(f"check {name} bitonic: bitonic_sort == sort_elements_xla (the radix sort) == the stable "
        f"torch.sort == the plain version on the card, bit for bit on tile, depth and index "
        f"({e} slots), its input unchanged; image_u8 == the AUTO frame's bit for bit; kernel "
        f"{res['ms']:.3f} ms vs plain {res['plain_ms']:.3f} ms, torch.sort "
        f"{res['library_ms']:.3f} ms; "
        f"bound {res['bound_ms']:.4f} ms (48 B a slot, {res['bound_by']}), the network's floor "
        f"{res['network_floor_ms']:.3f} ms ({planned} kernels x 24 B a slot); by kind "
        f"{res['device_ms']}; ptxas {' | '.join(ptxas)}")
    return res, launches, {k: v / drawn for k, v in launches.items()}


def count_syncs(fn):
    """Host synchronisations torch reports while `fn` runs (sync debug
    mode): (count, {"file:line": count} of the Python lines that caused
    them)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode("default")
    where = {}
    for w in caught:
        if "synchronizing" in str(w.message):
            code = linecache.getline(w.filename, w.lineno).strip()
            key = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno} {code}"
            where[key] = where.get(key, 0) + 1
    return sum(where.values()), where


def run_capped(name: str, mult: float):
    """The temporal capped path of one scene through Renderer."""
    table, config, cam, _target, frames = make_scene(name)
    config = dataclasses.replace(config, blend_depth_cap=CAP, blend_cap_max=CAP_MAX)
    renderer = Renderer(config, device="cuda", steady_frac=STEADY_FRAC,
                        log=lambda msg: log(f"  {name}: {msg}"))
    renderer.init_for_scene(scaled(table, mult))
    plan = renderer._plan
    chained = name == "garden30k_1080p"
    if chained != (plan is not None):
        raise RuntimeError(f"{name}: capacity {renderer.capacity} picked the wrong frame plan")
    warm = Renderer.WARMUP_FRAMES + 1 if chained else WARMUP_FRAMES
    base = cam.position.copy()
    step = [0]

    def draw(timer=None):
        cam.set_position(base + np.float32([CAPPED_NUDGE[name] * step[0], 0.0, 0.0]))
        step[0] += 1
        return renderer.draw(cam, timer=timer)

    reset_counts()
    live_before = None
    sorts = SortCalls()
    with Capture() as cap:
        for i in range(warm):
            if chained and i == warm - 1:  # this draw takes the steady switch
                live_before = int(plan.last_count)
            cap.new_frame()
            with sorts:
                out = draw()
            if chained:
                log(f"  {name} warm-up {i}: mode {plan.mode}, live {int(out.num_elements)}, "
                    f"ok {bool(out.ok)}, stats (n_invalid, fits, packed, n_grow, n_unfix) "
                    f"{plan.last_stats.tolist()}, filtered tiles "
                    f"{int((plan.state.thr != SENTINEL).sum())}/{config.num_tiles}, caps mean "
                    f"{float(plan.state.caps.float().mean()):.0f}")
        if chained and plan.mode != "steady":
            raise RuntimeError(f"{name}: the steady switch was not taken")
        syncs, sync_lines = count_syncs(lambda: [draw() for _ in range(SYNC_FRAMES)])
        for k in capped_ops.PATH_COUNTS:
            capped_ops.PATH_COUNTS[k] = 0
        timer = CudaPassTimer()
        events, oks = [], []
        before = read_counts()
        for _ in range(frames):
            cap.new_frame()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = draw(timer)
            end.record()
            events.append((start, end))
            oks.append(out.ok)
        torch.cuda.synchronize()
    launches = read_counts()
    per_frame = {k: (launches[k] - before[k]) / frames for k in launches}
    check_radix_kernels(f"{name} capped", call_plan(cap.args["radix_sort"]),
                        launches["radix_sort"], read_kernels()["radix_sort"])
    tables = cap.counts.get("pack_feature_table", 0)
    if tables:
        raise RuntimeError(f"{name} capped: the capped frames built {tables} feature tables")
    path_kernels = ["keygen_project", "expand_rows", "decode_slots", "radix_sort", "blend_flat",
                    "compact_slabs"]
    if chained:
        path_kernels += ["expand_rows_streamed", "keygen_count"]
    if min(launches[k] for k in path_kernels) == 0 or per_frame["radix_sort"] != 1:
        raise RuntimeError(f"{name} capped: a kernel of the path was not launched, or the radix "
                           f"sort not once a timed frame: {launches}, per timed frame {per_frame}")
    if sorts.calls:
        raise RuntimeError(f"{name} capped: {sorts.calls} torch.sort/argsort calls in {warm} "
                           f"warm-up frames")
    frame_ms = [s.elapsed_time(e) for s, e in events]
    passes = timer.summary()
    oks = [bool(o) for o in oks]
    check_image(out.image, config, f"{name} capped")
    if not oks[-1]:
        raise RuntimeError(f"{name} capped: ok is false on the last timed frame ({oks})")
    live_after = int(out.num_elements)
    if chained and not live_after < live_before:
        raise RuntimeError(f"{name}: live elements {live_before} -> {live_after} after the switch")
    log(f"capped {name}: {'ChainedTemporalPlan' if chained else 'temporal frame'}, capacity "
        f"{renderer.capacity}" + (f", steady capacity {plan.steady_capacity}" if chained else "")
        + (f", live {live_before} before the switch -> {live_after} after" if chained
           else f", live {live_after}")
        + f"; ms/frame median {statistics.median(frame_ms):.3f} (min {min(frame_ms):.3f}, "
        f"max {max(frame_ms):.3f}, {frames} frames); per pass ms "
        + ", ".join(f"{k} {passes[k]:.3f}" for k in
                    ("keygen", "expand", "sort", "ranges", "layout", "blend", "policy", "patch"))
        + f"; feature tables built {tables}; torch.sort/argsort calls in the {warm} warm-up "
        f"frames {sorts.calls}; frames fast/patch/full {dict(capped_ops.PATH_COUNTS)}; ok {oks}; "
        f"host syncs per "
        f"frame {syncs / SYNC_FRAMES:g} {sync_lines}; launches {launches}; per timed frame "
        f"{per_frame}")
    return renderer, cam, cap, out, launches, per_frame


def parent_gid(args, wmax: int) -> torch.Tensor:
    """The layout ids as the parent tree computed them on the card: the
    unmasked K5 kernel, then the live-lane mask from the K1 chunk map
    (ops/capped.py:_layout; the parent's patch pass found the same lanes by
    a search over the slab ends)."""
    src, starts, sbase, slabw, off, counts, ep = args
    gid_raw = compact_kernel.compact_runs(src, starts, sbase, ep, wmax)
    nchunks, align = ep // compact_kernel.CHUNK, compact_kernel.CHUNK
    cols, _ = expand_kernel.expand_rows(
        torch.stack([sbase // align, counts, off]).to(torch.int32), slabw // align, nchunks)
    cols = cols.to(torch.int64)
    chunk_local = (torch.arange(nchunks, device=src.device) - cols[0]) * align
    lo, hi = cols[2] - chunk_local, cols[2] + cols[1] - chunk_local
    lane = torch.arange(align, device=src.device)
    seg_live = ((lane >= lo[:, None]) & (lane < hi[:, None])).reshape(-1)
    return torch.where(seg_live & (gid_raw != SENTINEL), gid_raw, SENTINEL)


def check_slabs(args, wmax: int, what: str, gid: torch.Tensor | None = None) -> dict:
    """compact_slabs on one call's own inputs against its plain version,
    the parent's layout code (`parent_gid`) and, given, the layout's gid:
    every lane bit for bit.  Its bound: 8 B written a lane, 8 B read a live
    lane and its five [T] int64 tables."""
    src, starts, sbase, _slabw, off, counts, ep = args
    got = compact_kernel.compact_slabs(*args)
    refs = {"plain version": compact_kernel.compact_slabs_plain(*args),
            "parent's layout code": parent_gid(args, wmax)}
    if gid is not None:
        refs["layout's gid"] = gid
    for ref_name, ref in refs.items():
        if not torch.equal(got, ref):
            raise RuntimeError(f"{what}: compact_slabs differs from the {ref_name} at "
                               f"{int((got != ref).sum())} of {ep} lanes")
    live = int(torch.clamp(torch.minimum(counts, ep - sbase - off), min=0).sum())
    return {
        "max_abs_err": int((got - refs["plain version"]).abs().max()) if ep else 0,
        "library_ms": None,
        "ep": ep,
        "live": live,
        **bound(8 * ep + 8 * live + 40 * starts.shape[0], 0),
        "ms": cuda_ms(lambda: compact_kernel.compact_slabs(*args), 20),
        # The kernel alone, from the profiler (ms includes the host's launch).
        "device_ms": device_breakdown(lambda: compact_kernel.compact_slabs(*args)),
        "plain_ms": cuda_ms(lambda: compact_kernel.compact_slabs_plain(*args), 1),
        "parent_ms": cuda_ms(lambda: parent_gid(args, wmax), 10),
    }


def forced_patch_call(lay, elements, rng_, frame, config: RenderConfig, img):
    """The patch pass's compact_slabs arguments on a frame's own layout:
    the (up to 5) longest tiles the pass can take marked invalid."""
    r = lay.r
    fits = (r > 0) & (r <= capped_ops.PATCH_WMAX - capped_ops.SEG_ALIGN)
    pick = torch.topk(torch.where(fits, r, -1), 5).indices
    pick = pick[fits[pick]]
    valid = torch.ones_like(fits)
    valid[pick] = False
    with Capture() as c:
        capped_ops._patch_pass(img, valid, elements, rng_, frame, config)
    return c.calls["compact_slabs"][-1][0], int(pick.numel())


def check_capped(renderer: Renderer, cam: Camera, cap: Capture, out, name: str) -> dict:
    """The capped path's kernels against their plain versions on the last
    frame's own inputs, and the frame against the uncapped K2 frame."""
    config = renderer.config
    res = {}
    (lay, caps, elements, rng_, frame, _cfg, ep), _ = cap.calls["capped_finish"][-1]

    # K3 with T on the packed layout, reading the frame's own data, against
    # its plain version on the feature table: image and T bit for bit, and
    # the policy decisions from each T.
    pranges = torch.stack([lay.pstart, lay.pstart + lay.counts], dim=1)
    table = blend_kernel.pack_feature_table(frame)
    img, t_k = blend_kernel.blend_flat(frame, lay.gid, pranges, config, with_t=True)
    ref, t_p = blend_ops.blend_flat_plain(table, lay.gid, pranges, config, with_t=True)
    check_image(img, config, f"{name} K3")
    for what, a, b in (("image", img, ref), ("T", t_k, t_p)):
        if not torch.equal(a, b):
            raise RuntimeError(f"{name}: blend_flat {what} differs from its plain version at "
                               f"{int((a != b).sum())} values, max |Δ| "
                               f"{float((a - b).abs().max()):.3e}")
    c, thr, floor = capped_ops._split_caps(caps, config)
    decisions = []
    for t_out in (t_k, t_p):
        t_max = t_out.amax(dim=1)
        valid = capped_ops._tile_validity(t_max, lay.r, lay.counts, lay.filtered, config)
        nxt = capped_ops._policy_update(config, ep, c, thr, floor, lay.r, lay.counts, rng_[:, 0],
                                        elements.depth, t_max, valid, lay.fits, lay.pcum_end)
        decisions.append([valid, *(x for x in nxt[:3] if x is not None)])
    for what, a, b in zip(("valid", "caps", "thr", "floor"), *decisions):
        if not torch.equal(a, b):
            raise RuntimeError(f"{name}: {what} from K3's T differs from the plain version's "
                               f"({int((a != b).sum())} tiles)")
    work = blend_work(table, lay.gid, pranges, config, in_image=False)
    nt = config.num_tiles
    out_bytes = 16 * nt + 12 * config.width * config.height + 4 * nt * config.tile_size**2
    # Bound with P_batch (what K3's T semantics must evaluate), and with P
    # beside it.
    per_pixel = bound(8 * work["slots"] + FRAME_ROW_BYTES * work["rows"] + out_bytes,
                      work["ops"])
    res["blend_flat"] = {
        "max_abs_err": float((img - ref).abs().max()),
        "library_ms": None,
        "work": work,
        **bound(8 * work["slots_batch"] + FRAME_ROW_BYTES * work["rows_batch"] + out_bytes,
                work["ops_batch"]),
        "ms": cuda_ms(lambda: blend_kernel.blend_flat(frame, lay.gid, pranges, config,
                                                      with_t=True), 20),
        "plain_ms": cuda_ms(lambda: blend_ops.blend_flat_plain(
            blend_kernel.pack_feature_table(frame), lay.gid, pranges, config, with_t=True), 1),
    }

    # K5: compact_slabs on the layout's call and on a patch pass's, against
    # its plain version and the parent's layout code, every lane; the
    # unmasked compact_runs on the layout's slabs, every lane.
    slabs = next(a for a, _k in reversed(cap.calls["compact_slabs"]) if a[6] == ep)
    wmax = capped_ops._round_up(config.blend_cap_max, capped_ops.SEG_ALIGN) + capped_ops.SEG_ALIGN
    k5 = check_slabs(slabs, wmax, f"{name} layout", lay.gid)
    patch_args, patch_tiles = forced_patch_call(lay, elements, rng_, frame, config, out.image)
    k5_patch = check_slabs(patch_args, capped_ops.PATCH_WMAX, f"{name} patch pass")
    res["compact_slabs"] = {**k5, "patch": k5_patch, "patch_tiles": patch_tiles}
    src, starts, sbases, _slabw, _off, _counts, ep5 = slabs
    got = compact_kernel.compact_runs(src, starts, sbases, ep5, wmax)
    want = compact_kernel.compact_runs_plain(src, starts, sbases, ep5, wmax)
    if not torch.equal(got, want):
        raise RuntimeError(f"{name}: compact_runs differs from its plain version at "
                           f"{int((got != want).sum())} of {ep5} lanes")
    res["compact_runs"] = {
        "max_abs_err": int((got - want).abs().max()),
        "library_ms": None,
        **bound(16 * ep5 + 16 * starts.shape[0], 0),
        "ms": cuda_ms(lambda: compact_kernel.compact_runs(src, starts, sbases, ep5, wmax), 20),
        "plain_ms": cuda_ms(lambda: compact_kernel.compact_runs_plain(src, starts, sbases, ep5,
                                                                     wmax), 1),
    }
    # K6 on the chunk offsets of the same slabs.
    live = lay.gid != SENTINEL
    astarts, sb = compact_kernel._runs_offsets(src, starts, sbases, ep5, wmax)
    chunk0 = torch.arange(ep5 // compact_kernel.CHUNK, device=src.device) * compact_kernel.CHUNK
    owner = torch.clamp(torch.searchsorted(sb, chunk0, right=True) - 1, min=0)
    src0 = astarts[owner] + chunk0 - sb[owner]
    compact_kernel.SEGMENTS_LAUNCHES = 0
    got6 = compact_kernel.compact_segments(src, src0, ep5)
    check_launches = compact_kernel.SEGMENTS_LAUNCHES
    want6 = compact_kernel.compact_segments_plain(src, src0, ep5)
    if not torch.equal(got6, want6) or not torch.equal(got6[live], got[live]):
        raise RuntimeError(f"{name}: compact_segments differs")
    res["compact_segments"] = {
        "check_launches": check_launches,
        "max_abs_err": int((got6 - want6).abs().max()),
        "library_ms": None,
        **bound(16 * ep5 + 8 * src0.shape[0], 0),
        "ms": cuda_ms(lambda: compact_kernel.compact_segments(src, src0, ep5), 20),
        # The kernel alone, from the profiler (ms includes the host's launch).
        "device_ms": device_breakdown(lambda: compact_kernel.compact_segments(src, src0, ep5)),
        "plain_ms": cuda_ms(lambda: compact_kernel.compact_segments_plain(src, src0, ep5), 3),
    }

    # K7 and K8 on the prefiltered frame's own call (the live thresholds).
    keygen_call = [c for c in cap.calls["project_gaussians"] if c[0][5] is not None][-1]
    if keygen_call[0][6] is not None:
        res["capped_keygen"] = check_keygen({"project_gaussians": keygen_call,
                                             "decode_slots": cap.calls["decode_slots"][-1]},
                                            f"{name} capped")

    # The radix sort on the last frame's list.
    res["capped_radix"] = check_radix(cap.args["radix_sort"], f"{name} capped")

    # K1' under the prefilter.
    if cap.calls.get("expand_rows_streamed"):
        (cols, counts, capacity), _ = cap.calls["expand_rows_streamed"][-1]
        fn = expand_kernel.expand_rows_streamed
        g, total = fn(cols, counts, capacity)
        w, want_total = expand_kernel.expand_rows_plain(cols, counts, capacity)
        n_live = min(int(total), capacity)
        if int(total) != int(want_total) or not torch.equal(g[:, :n_live], w[:, :n_live]):
            raise RuntimeError(f"{name}: expand_rows_streamed differs from its plain version")
        res["expand_rows_streamed"] = {
            "max_abs_err": int((g.to(torch.int64) - w.to(torch.int64)).abs().max()),
            "ms": cuda_ms(lambda: fn(cols, counts, capacity), 20),
            "plain_ms": cuda_ms(lambda: expand_kernel.expand_rows_plain(cols, counts, capacity), 3),
            "library_ms": cuda_ms(lambda: torch.repeat_interleave(cols, counts, dim=1), 10),
            **expand_bound(cols, counts, capacity),
        }

    # The capped frame against the uncapped K2 frame of the same camera.
    view, proj = cam.matrices()
    unc = render_frame(renderer.table, view, proj, cam.position,
                       config=dataclasses.replace(config, blend_depth_cap=0),
                       capacity=renderer.capacity)
    vs_k2 = u8_compare(out.image, unc.image)
    if max(mx for mx, _ in vs_k2) > 1:
        raise RuntimeError(f"{name}: capped vs uncapped 8-bit (max, share>1) per channel {vs_k2}")
    log(f"check {name} capped: blend_flat (on the frame data) == plain bit for bit, image and "
        f"T, valid/caps/thr/floor from "
        f"either T equal; kernel {res['blend_flat']['ms']:.3f} ms vs plain "
        f"{res['blend_flat']['plain_ms']:.3f} ms; K3 bound {res['blend_flat']['bound_ms']:.4f} ms "
        f"with P_batch ({res['blend_flat']['bound_by']}), {per_pixel['bound_ms']:.4f} with P "
        f"({work}); compact_slabs == plain == the parent's layout code == the layout's gid on "
        f"all {k5['ep']} lanes ({k5['live']} live), {k5['ms']:.4f} ms vs plain "
        f"{k5['plain_ms']:.3f}, kernels {k5['device_ms']}, the parent's id passes "
        f"{k5['parent_ms']:.4f}, bound "
        f"{k5['bound_ms']:.4f} ({k5['bound_bytes']} B); on the patch pass ({patch_tiles} tiles "
        f"marked invalid) == plain == the parent's code on all {k5_patch['ep']} lanes "
        f"({k5_patch['live']} live), {k5_patch['ms']:.4f} ms, kernels {k5_patch['device_ms']}, "
        f"bound {k5_patch['bound_ms']:.4f}; "
        f"compact_runs (unmasked, off the path) == plain on all {ep5} lanes, "
        f"{res['compact_runs']['ms']:.3f} ms vs plain {res['compact_runs']['plain_ms']:.3f}, "
        f"bound {res['compact_runs']['bound_ms']:.4f}; compact_segments bit-exact, "
        f"{res['compact_segments']['ms']:.3f} ms vs plain {res['compact_segments']['plain_ms']:.3f}, "
        f"kernels {res['compact_segments']['device_ms']}, "
        f"bound {res['compact_segments']['bound_ms']:.4f}"
        + "".join(f"; {k} bit-exact, {res[k]['ms']:.3f} ms vs plain {res[k]['plain_ms']:.3f}, "
                  f"repeat_interleave {res[k]['library_ms']:.3f}, bound {res[k]['bound_ms']:.4f} "
                  f"({res[k]['bound_by']})"
                  for k in ("expand_rows_streamed",) if k in res)
        + f"; capped vs uncapped K2 frame 8-bit (max, share>1) per channel {vs_k2}")
    return res


def probe_motion(renderer: Renderer, cam: Camera, name: str) -> None:
    """garden's chained plan under the uncapped phases' camera step:
    records what the steady set does (not a check)."""
    frames, step = MOTION_PROBE
    base = cam.position.copy()
    rows = []
    for i in range(1, frames + 1):
        cam.set_position(base + np.float32([step * i, 0.0, 0.0]))
        out = renderer.draw(cam)
        rows.append((renderer._plan.mode, int(out.num_elements), bool(out.ok),
                     int(renderer._plan.last_stats[4])))
    log(f"motion probe {name} (step {step}/frame, not a check): (mode, live, ok, n_unfix) "
        f"per frame {rows}")


def dist_camera(cam: Camera, base, step: int) -> Camera:
    cam.set_position(base + np.float32([DIST_NUDGE * step, 0.0, 0.0]))
    return cam


def dist_rank(rank: int, world: int, name: str, mult: float, warm: int, timed: int,
              outdir: str) -> None:
    """One rank of the distributed phase, in its own spawned process: the
    scene rebuilt from its seed at the calibrated scale, this rank's shard,
    warm + timed frames of make_distributed_render's frame function, then K4
    against its plain version on every phase of the last frame.  What it
    found goes to <outdir>/rank<rank>.pt."""
    torch.cuda.set_device(0)
    table, config, cam, _target, _frames = make_scene(name)
    padded = dist._pad_table(scaled(table, mult), world)
    shard = dist.shard_table(padded, rank, world).to("cuda")
    plan = dist.plan_distribution(config, padded.num_gaussians, world)
    del table, padded
    comm = mesh.Communicator("cuda")
    frame = dist.make_distributed_render(comm, config, plan, return_stats=True)
    base = cam.position.copy()
    timer = CudaPassTimer()
    events = []
    reset_counts()
    with Capture() as cap:
        for i in range(warm + timed):
            cap.new_frame()
            dist_camera(cam, base, DIST_LAST_STEP - (warm + timed - 1 - i))
            view, proj = cam.matrices()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            strip, stats = frame(shard, view, proj, cam.position, timer=timer if i >= warm else None)
            end.record()
            if i >= warm:
                events.append((start, end))
        torch.cuda.synchronize()
    launches = read_counts()
    radix_kernels = check_radix_kernels(f"rank {rank}", call_plan(cap.args["radix_sort"]),
                                        launches["radix_sort"], read_kernels()["radix_sort"])
    passes = {k: v / timed for k, v in timer.totals().items()}

    # K4 on each phase's own inputs (launches here are not the path's).
    phases = cap.calls["blend_strip"]
    if len(phases) != world:
        raise RuntimeError(f"rank {rank}: {len(phases)} blend_strip calls in a frame, not {world}")
    err = 0.0
    stopped_early = 0
    for s, (a, k) in enumerate(phases):
        got = blend_kernel.blend_strip(*a, **k)
        want = blend_ops.blend_strip_plain(*a, **k)
        fault = blend_kernel.strip_mismatch(got, want, a[3].transmittance_stop)
        if fault:
            raise RuntimeError(f"rank {rank} phase {s}: blend_strip {fault}")
        err = max(err, float((got[0] - want[0]).abs().max()))
        stopped_early += int((got[1] != want[1]).sum())
    k4 = {"max_abs_err": err, "log_t_stopped_early": stopped_early}
    # The radix sort on the last frame's received list (_sort3's call).
    radix = check_radix(cap.args["radix_sort"], f"rank {rank}", timed=False)
    tdist.barrier()
    if rank == 0:  # timed while the other ranks wait, so the card is this rank's
        k4["ms"] = statistics.mean(
            cuda_ms(lambda: blend_kernel.blend_strip(*a, **k), 20) for a, k in phases)
        k4["plain_ms"] = statistics.mean(
            cuda_ms(lambda: blend_ops.blend_strip_plain(*a, **k), 1) for a, k in phases)
        # The bound of the mean phase with P (K4 stops each pixel), and with
        # P_batch beside it: each phase's slots (routed rows are read per
        # slot, gathered rows per gaussian), ranges, and the carry in and
        # out, 16 B a pixel each way.
        work = {"": [], "_batch": []}
        for (rows, index, ranges_, cfg), k in phases:
            w = blend_work(rows, index, ranges_, cfg, in_image=False, tile_base=k["tile_base"],
                           trans=torch.exp(k["carry_logt"]), gather=k["gather"])
            for sfx, pairs in work.items():
                slots = w["slots" + sfx]
                row_bytes = TABLE_ROW_BYTES * (w["rows" + sfx] if k["gather"] else slots)
                pairs.append((8 * slots + row_bytes + 16 * ranges_.shape[0]
                              + 32 * k["carry_logt"].numel(), w["ops" + sfx]))
        for sfx, pairs in work.items():
            b = bound(statistics.mean(x for x, _ in pairs), statistics.mean(o for _, o in pairs))
            k4.update(b if not sfx else {"bound_ms_batch": b["bound_ms"]})
        k4["library_ms"] = None
    tdist.barrier()
    torch.save({
        "strip": strip.cpu(),
        "stats": stats.reshape(4).tolist(),
        "frame_ms": [s.elapsed_time(e) for s, e in events],
        "passes": passes,
        "launches": launches,
        "k4": k4,
        "radix": {**radix, "kernels_per_sort": radix_kernels},
        "host_staged": comm.host_staged,
        "plan": tuple(plan),
        "elements": [int((a[2][:, 1] - a[2][:, 0]).clamp(min=0).sum()) for a, _k in phases],
    }, f"{outdir}/rank{rank}.pt")


# The kernels every rank of the distributed frame launches.
DIST_KERNELS = ("keygen_project", "expand_rows", "decode_slots", "radix_sort", "blend_strip")


def run_dist(mult: float) -> dict:
    """The distributed phase: each run of DIST_RUNS spawns its ranks, which
    report back through files; their stats, launches, K4 checks and the
    assembled image are checked here."""
    name = DIST_SCENE
    table, config, cam, _target, _frames = make_scene(name)
    base = cam.position.copy()
    renderer = Renderer(config, device="cuda")
    renderer.init_for_scene(scaled(table, mult))
    ref = renderer.draw(dist_camera(cam, base, DIST_LAST_STEP)).image.cpu()
    del renderer, table
    torch.cuda.empty_cache()

    out = {}
    for backend, world, warm, timed in DIST_RUNS:
        what = f"dist {name} {backend} world {world}"
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as outdir:
            multihost.launch(dist_rank, world, backend=backend, init_method=f"file://{outdir}/store",
                             args=(name, mult, warm, timed, outdir))
            ranks = [torch.load(f"{outdir}/rank{r}.pt", weights_only=False) for r in range(world)]
        wall_s = time.perf_counter() - t0
        stats = np.array([r["stats"] for r in ranks], np.int64)
        live, sent, recv, dropped = stats.T
        if not (sent == live).all():
            raise RuntimeError(f"{what}: slab drops, [live, sent, recv, dropped] per rank {stats}")
        if recv.sum() != sent.sum() or dropped.sum() != 0:
            raise RuntimeError(f"{what}: elements lost in the exchange or the strip windows: {stats}")
        if recv.max() > 3 * max(recv.min(), 1):
            raise RuntimeError(f"{what}: the depth bands did not balance the ranks: {stats}")
        for k in DIST_KERNELS:
            if min(r["launches"][k] for r in ranks) == 0:
                raise RuntimeError(f"{what}: {k} was not launched on every rank")
        if any(r["launches"]["radix_sort"] != warm + timed for r in ranks):
            raise RuntimeError(f"{what}: the radix sort must launch once a frame on every rank: "
                               f"{[r['launches']['radix_sort'] for r in ranks]}")
        img = torch.cat([r["strip"] for r in ranks])[: config.height, : config.width]
        check_image(img, config, what)
        vs_ref = u8_compare(img, ref)
        if max(mx for mx, _ in vs_ref) > 1:
            raise RuntimeError(f"{what}: vs the single-device frame 8-bit (max, share>1) per "
                               f"channel {vs_ref}")
        k4 = ranks[0]["k4"]
        exchange = (f"host-staged gloo, {world} ranks on one card, not NCCL"
                    if ranks[0]["host_staged"] else backend)
        log(f"{what}: plan {ranks[0]['plan']}, {wall_s:.1f} s with spawn and set-up; exchange "
            f"{exchange}; ms/frame per rank (median of {timed}) "
            f"{[round(statistics.median(r['frame_ms']), 3) for r in ranks]}; per pass ms per rank "
            + ", ".join(f"{p} {[round(r['passes'].get(p, 0.0), 3) for r in ranks]}"
                        for p in DIST_PASSES)
            + f"; [live, sent, recv, dropped] per rank {stats.tolist()}; strip slots per phase "
            f"{[r['elements'] for r in ranks]}; launches per rank "
            f"{[{k: r['launches'][k] for k in DIST_KERNELS} for r in ranks]}")
        log(f"check {what}: blend_strip == plain on the {world} phases of every rank (colour bit "
            f"for bit; log T bit for bit where T >= the stop, both T below the stop elsewhere: "
            f"{sum(r['k4']['log_t_stopped_early'] for r in ranks)} pixels stopped before the "
            f"plain version's batch end); radix_sort (every slot, with the permutation) == plain "
            f"== stable torch.sort bit for bit on every rank's last list "
            f"({[r['radix']['e'] for r in ranks]} slots; "
            f"{[r['radix']['kernels_per_sort'] for r in ranks]} kernels a sort); K4 kernel "
            f"{k4['ms']:.3f} ms vs plain {k4['plain_ms']:.3f} ms, bound {k4['bound_ms']:.4f} ms "
            f"with P ({k4['bound_by']}), "
            f"{k4['bound_ms_batch']:.4f} with P_batch (mean per phase, rank 0 alone on the card); "
            f"image vs the single-device uncapped "
            f"frame float max |Δ| {float((img - ref).abs().max()):.3e}, 8-bit (max, share>1) per "
            f"channel {vs_ref}")
        out[(backend, world)] = {
            "launches": {k: sum(r["launches"][k] for r in ranks) for k in DIST_KERNELS},
            "blend_strip": {**k4, "max_abs_err": max(r["k4"]["max_abs_err"] for r in ranks)},
            "per_rank_frame": {k: statistics.mean(r["launches"][k] for r in ranks) / (warm + timed)
                               for k in COUNTERS},
        }
    return out


APP_SCENE = "garden30k_1080p"
APP_FRAMES = 3
FIXTURE = "tests/fixtures/gs_export_384.ply"
FIXTURE_GOLDEN = "tests/golden/ply_fixture.png"


class _LogLines(logging.Handler):
    """Keeps the messages of the port's logger (utils/log.py)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_app(mult: float) -> dict:
    """The app path at garden's size: the calibrated stand-in written with
    write_gaussian_ply (~1.38 GB, in a temporary directory deleted after),
    loaded by load_gaussians through the native parser and held bit for bit
    to the numpy parser's table, then the CLI on the card (`--ply`, 1920x1080,
    APP_FRAMES frames, `--out`), whose PNG must equal Renderer.draw on the
    same table and camera bit for bit; last the .ply fixture rendered as
    tests/test_ply_fixture.py does, within ±1 8-bit of its golden PNG.  The
    CLI runs twice, the second time with `--sort bitonic`, whose PNG must
    equal the first.  Returns each CLI run's launches a frame, and both
    runs' launches."""
    table, _config, _cam, _target, _frames = make_scene(APP_SCENE)
    table = scaled(table, mult)
    n, width, height = SCENES[APP_SCENE][:3]
    lines = _LogLines()
    logging.getLogger("vk3dgs_tpu_torch").addHandler(lines)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path, png = os.path.join(tmp, "garden.ply"), os.path.join(tmp, "frame.png")
            t0 = time.perf_counter()
            ply.write_gaussian_ply(path, table)
            write_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            del table
            t0 = time.perf_counter()
            loaded = ply.load_gaussians(path)
            ply_load_s = time.perf_counter() - t0
            report = [ln for ln in lines.lines if ln.startswith("load_gaussians")][-1]
            if "native parser" not in report or loaded.num_gaussians != n:
                raise RuntimeError(f"app: load_gaussians did not take the native parser: {report}")
            t0 = time.perf_counter()
            ref = from_raw_ply_columns(**ply.gaussian_columns_from_ply(path))
            numpy_s = time.perf_counter() - t0
            for f in dataclasses.fields(GaussianTable):
                if not torch.equal(getattr(loaded, f.name), getattr(ref, f.name)):
                    raise RuntimeError(f"app: native and numpy parsers differ in {f.name}")
            del ref

            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(["--ply", path, "--width", str(width), "--height", str(height),
                           "--frames", str(APP_FRAMES), "--out", png])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = read_counts()
            if rc != 0 or any(launches[k] != APP_FRAMES for k in UNCAPPED_PATH):
                raise RuntimeError(f"app: the CLI returned {rc}, launches {launches}")
            # The CLI's uncapped frame sorts the count's prefix.
            check_radix_kernels("app", (RenderConfig(width=width, height=height).num_tiles, True),
                                launches["radix_sort"], read_kernels()["radix_sort"])
            got = image_io.read_png(png)

            # The CLI again with the bitonic tier: the same PNG.
            reset_counts()
            bitonic_kernel.PASSES = 0
            t0 = time.perf_counter()
            rc = cli.main(["--ply", path, "--width", str(width), "--height", str(height),
                           "--frames", str(APP_FRAMES), "--sort", "bitonic", "--out", png])
            torch.cuda.synchronize()
            bitonic_s = time.perf_counter() - t0
            bitonic_launches = read_counts()
            planned = bitonic_kernel.planned_passes(RenderConfig(width=width, height=height)
                                                    .sort_capacity(n))
            if rc != 0 or any(bitonic_launches[k] != APP_FRAMES for k in BITONIC_PATH) or (
                    bitonic_kernel.PASSES != APP_FRAMES * planned
                    or bitonic_launches["radix_sort"]):
                raise RuntimeError(f"app: the bitonic CLI returned {rc}, launches "
                                   f"{bitonic_launches}, {bitonic_kernel.PASSES} kernels")
            got_bitonic = image_io.read_png(png)
            if not np.array_equal(got_bitonic, got):
                raise RuntimeError("app: the CLI's --sort bitonic PNG differs from its --sort auto PNG")
    finally:
        logging.getLogger("vk3dgs_tpu_torch").removeHandler(lines)
    config = RenderConfig(width=width, height=height)  # the CLI's
    renderer = Renderer(config, device="cuda")
    renderer.init_for_scene(loaded)
    cam = Camera(config.aspect)
    cam.set_position((0.0, 0.0, 2.0))  # the CLI's .ply scene camera
    cam.set_rotation(math.pi, 0.0)
    out = renderer.draw(cam)
    want = out.image_u8.cpu().numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        raise RuntimeError(f"app: the CLI's PNG {got.shape} differs from Renderer.draw {want.shape}")
    check_image(out.image, config, "app CLI frame")
    del renderer, loaded, out
    torch.cuda.empty_cache()

    fixture_config = RenderConfig(width=192, height=96, capacity_slack_per_tile=32)
    renderer = Renderer(fixture_config, device="cuda")
    renderer.init_for_scene(ply.load_gaussians(FIXTURE))
    cam = Camera(fixture_config.aspect)
    cam.set_position((0.0, 0.0, 2.5))
    cam.set_rotation(math.pi, 0.0)
    fixture = renderer.draw_numpy(cam).astype(np.int32)
    golden = image_io.read_png(FIXTURE_GOLDEN).astype(np.int32)
    d = int(np.abs(fixture - golden).max()) if fixture.shape == golden.shape else None
    if d is None or d > 1:
        raise RuntimeError(f"app: the .ply fixture vs its golden PNG, 8-bit max |Δ| {d}")
    log(f"app {APP_SCENE}: write_gaussian_ply {n} gaussians, {size} B in {write_s:.2f} s; "
        f"ply_load_s {ply_load_s:.3f} (native parser, {report!r}); numpy parser "
        f"{numpy_s:.2f} s, tables equal bit for bit; CLI --ply {width}x{height} "
        f"{APP_FRAMES} frames in {cli_s:.2f} s with the load, launches {launches}; its PNG == "
        f"Renderer.draw bit for bit; --sort bitonic in {bitonic_s:.2f} s, launches "
        f"{bitonic_launches} ({planned} kernels a sort), its PNG == the first bit for bit; "
        f"fixture .ply vs golden 8-bit max |Δ| {d}")
    total = {k: launches[k] + bitonic_launches[k] for k in launches}
    return ({k: v / APP_FRAMES for k, v in launches.items()},
            {k: v / APP_FRAMES for k, v in bitonic_launches.items()}, total)


# Kernels that no path of the port runs, held to their plain versions in the
# check phase only: K6 (the JAX package has no production caller either),
# and K5's unmasked TPU function, which `compact_slabs` replaced on the
# capped path and which is reported on the capped check's line, not in the
# kernels line.
OFF_PATH = ("compact_segments", "compact_runs")

META = {
    "expand_rows": ("vk3dgaussiansplatting_tpu_torch/csrc/expand.cu",
                    "vk3dgaussiansplatting_tpu/ops/pallas/expand_kernel.py:516"),
    "expand_rows_streamed": ("vk3dgaussiansplatting_tpu_torch/csrc/expand.cu",
                             "vk3dgaussiansplatting_tpu/ops/pallas/expand_kernel.py:422"),
    "blend_tiles": ("vk3dgaussiansplatting_tpu_torch/csrc/blend.cu",
                    "vk3dgaussiansplatting_tpu/ops/pallas/blend_kernel.py:760"),
    "blend_flat": ("vk3dgaussiansplatting_tpu_torch/csrc/blend_flat.cu",
                   "vk3dgaussiansplatting_tpu/ops/pallas/blend_kernel.py:647"),
    "compact_slabs": ("vk3dgaussiansplatting_tpu_torch/csrc/compact.cu",
                      "vk3dgaussiansplatting_tpu/ops/pallas/compact_kernel.py:120"),
    "compact_segments": ("vk3dgaussiansplatting_tpu_torch/csrc/compact.cu",
                         "vk3dgaussiansplatting_tpu/ops/pallas/compact_kernel.py:212"),
    "blend_strip": ("vk3dgaussiansplatting_tpu_torch/csrc/blend_strip.cu",
                    "vk3dgaussiansplatting_tpu/ops/pallas/blend_kernel.py:808"),
    # Not TPU kernels: XLA functions of the JAX package (NOT_TPU_KERNELS).
    "bitonic_sort": ("vk3dgaussiansplatting_tpu_torch/csrc/bitonic.cu",
                     "vk3dgaussiansplatting_tpu/ops/bitonic.py:38"),
    "keygen_project": ("vk3dgaussiansplatting_tpu_torch/csrc/keygen.cu",
                       "vk3dgaussiansplatting_tpu/ops/keygen.py:126"),
    "decode_slots": ("vk3dgaussiansplatting_tpu_torch/csrc/keygen.cu",
                     "vk3dgaussiansplatting_tpu/ops/keygen.py:126"),
    # Also the distributed frame's 3-key sort, parallel/dist.py:195 _sort3.
    "radix_sort": ("vk3dgaussiansplatting_tpu_torch/csrc/radix.cu",
                   "vk3dgaussiansplatting_tpu/ops/sort.py:37"),
}
NOT_TPU_KERNELS = ("bitonic_sort", "keygen_project", "decode_slots", "radix_sort")


def main() -> None:
    kind = phase_device()
    phase_build()
    check_keygen_ptxas()
    check_radix_ptxas()
    phase_fixtures()
    check_expand_edge_cases()
    check_radix_edge_cases()

    results = {}
    launches = dict.fromkeys(COUNTERS, 0)
    per_frame = {}  # path -> kernel -> launches a frame
    mults = {}
    for i, name in enumerate(SCENES):
        (renderer, cam, args, scene_launches, mults[name], per_frame["uncapped"], passes,
         radix_kernels) = run_scene(name)
        if i == 0:
            check_elements_vs_cpu(renderer, cam)
        results[name] = check_kernels(args, renderer.config, name, passes)
        # The SH modes at train7k: the frame's own, then the other two.
        results[name].update(check_keygen(
            args, name, [m for m in SphericalHarmonicsMode if m != renderer.config.sh_mode]
            if i == 0 else ()))
        results[name]["radix_sort"] = check_radix(args["radix_sort"], name)
        # The kernels a sort that the uncapped frames launched.
        results[name]["radix_sort"]["kernels_per_sort"] = radix_kernels
        for k, v in scene_launches.items():
            launches[k] += v
        del renderer, args
        torch.cuda.empty_cache()
    for name in SCENES:
        results[name]["bitonic_sort"], path_launches, per_frame["bitonic"] = run_bitonic(
            name, mults[name])
        for k, v in path_launches.items():
            launches[k] += v
        torch.cuda.empty_cache()
    for name in SCENES:
        renderer, cam, cap, out, path_launches, capped_frame = run_capped(name, mults[name])
        per_frame["capped_steady" if renderer._plan is not None else "capped_temporal"] = capped_frame
        for k in ("keygen_project", "keygen_count", "expand_rows", "expand_rows_streamed",
                  "decode_slots", "radix_sort", "blend_flat", "compact_slabs"):
            launches[k] += path_launches[k]
        results[name].update(check_capped(renderer, cam, cap, out, name))
        if renderer._plan is not None:
            probe_motion(renderer, cam, name)
        del renderer, cap, out
        torch.cuda.empty_cache()
    per_frame["app_cli"], per_frame["app_cli_bitonic"], app_launches = phase_app(mults[APP_SCENE])
    for k, v in app_launches.items():
        launches[k] += v
    dist_runs = run_dist(mults[DIST_SCENE])
    for run in dist_runs.values():
        for k, v in run["launches"].items():
            launches[k] += v
    # K4's line: the first run's (world 4, gloo), its error the worst of both.
    first_run = next(iter(dist_runs.values()))
    per_frame["distributed_per_rank"] = first_run["per_rank_frame"]
    results["dist"] = {"blend_strip": {
        **first_run["blend_strip"],
        "max_abs_err": max(r["blend_strip"]["max_abs_err"] for r in dist_runs.values()),
    }}
    log(f"launches: {launches} over the uncapped and capped paths of {len(SCENES)} scenes, "
        f"the CLI's frames and the distributed path's ranks; per frame by path {per_frame}")
    on_path = {k: v for k, v in launches.items() if k not in OFF_PATH}
    if min(on_path.values()) == 0:
        raise RuntimeError(f"a kernel of the paths was never launched: {launches}")

    # Each kernel's times and bound from the largest inputs it ran on (the
    # distributed run for K4, garden for the rest where it ran).
    kernels = []
    for k, (src, rep) in META.items():
        scene, res = next((s, r[k]) for s, r in reversed(results.items()) if k in r)
        entry = {
            "name": k,
            "route": "cuda",
            "source": src,
            "replaces": rep,
            "launches": launches[k],
            "on_path": k not in OFF_PATH,
            "tpu_kernel": k not in NOT_TPU_KERNELS,
            "max_abs_err": max(r[k]["max_abs_err"] for r in results.values() if k in r),
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res["library_ms"],
            "launches_per_frame": {path: counts[k] for path, counts in per_frame.items()},
            "inputs": DIST_SCENE + " distributed" if scene == "dist" else scene,
        }
        if k in OFF_PATH:
            entry["check_launches"] = sum(r[k]["check_launches"] for r in results.values()
                                          if k in r)
        if k == "keygen_project":  # its counts mode (count_live_elements)
            entry.update(count_launches=launches["keygen_count"], count_ms=res["count_ms"])
        if k == "radix_sort":
            entry.update(kernels_per_sort=res["kernels_per_sort"], device_ms=res["device_ms"],
                         copy_ms=res["copy_ms"], scatter_pass_ms=res["scatter_pass_ms"])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
