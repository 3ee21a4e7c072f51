#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vk3dgaussiansplatting_tpu_torch) on one
NVIDIA GPU, through `Renderer` as a user drives it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, one line each (any failure raises, and the exit code is non-zero):

  device   the card's name, and name + power limit from nvidia-smi
  build    the CUDA kernels compiled from csrc/, one nvcc per source, all
           started together (seconds, ptxas report); K7, K1 and the radix
           sort's ten kernels (the depth order's prep and scan included)
           without a spill or a stack, or the run fails;
           csrc/radix.cu's constants (vk3d_radix_config) equal to
           radix_kernel's copies
  fixture  the fixture scenes on the card (kernels) against the CPU (plain
           versions): element counts equal, 8-bit ±1 per channel
  check    K1 against its plain version bit for bit on edge cases (zero
           counts, a 12,000-slot gaussian, 1.1M zero counts in a row,
           total > E, E % 4 != 0, N = 0), as rows and, over six columns
           made as keygen's, as sort elements (`expand_elements`); the radix sort five times with
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
           CUDA events; K7, the depth order, K1, the radix sort (with two
           columns: "radix_two_column") and K2
           launch once a frame, the radix kernels (LAUNCHES["radix_kernels"])
           are the tile key's planned_kernels a sort and
           DEPTH_ORDER_KERNELS a depth order, no feature table is built, and the
           warm-up frames call no torch.sort or argsort (a
           TorchFunctionMode counts them); one more frame under
           torch.profiler: its keygen pass is K7, the depth order's memset,
           prep, four scatters and scan, and K1's partition and expansion
           kernels in a row, no other device op between them
           (`check_keygen_pass`; so on the capped and CLI paths; the
           distributed path has no depth order)
  check    on that scene's last frame: keygen/sort/ranges on the card ==
           on the CPU bit for bit, the depth-first way == the index order
           on the full key; K1 (`expand_elements`, the expansion
           that stores the sort elements) == its plain version
           (decode_slots_plain over expand_rows_plain) bit for bit on
           the frame's own rows, its time, plain time and bound (the
           rows that own a live slot and the scan read, 24 B a slot and
           the count written); K2
           (blend_tiles on the frame's own GaussianFrameData) vs its plain
           version per channel 8-bit max |Δ| <= 2 with |Δ| > 1 on at most
           1e-4 of pixel-channels; kernel, plain and library times and the
           bound.  K7 keygen_project against project_gaussians_plain on the
           frame's own table, camera and config (train7k also in the other
           two SH modes): the packed int32 rows (depth keys, extents), the
           extents and the visible / keep flags bit for bit; each float
           column of the frame data within 1 ulp on at most 1e-6 of its
           values, every differing gaussian checked to be an _fma tie of the
           plain version (`fma_ties`); the offset row, the scan `cum` and
           the total bit for bit; the SH rows it read (`sh_rows_read`: the
           gaussians whose count is above 0, as the plain version's) and
           an rgb of 0 everywhere else; its counts mode (total, extents,
           flags) bit for bit; its time, plain time and bound (124 B a
           gaussian, 192 B more a gaussian that emits), K7's counts
           mode and the wrapper's host µs a call; at garden, K7 alone at
           its first pose and at a pose that sees every gaussian
           (`k7_poses`, the rows read and their share; `ab_k7` runs it on
           two trees).  The radix sort on the
           frame's own keygen output (tile and index, no depth) five times
           (equal results) and against its plain version and the stable
           torch.sort it replaced, bit for bit, its input unchanged; its
           time, the plain version's, torch.sort's (library_ms), its
           kernels by kind from the profiler (setup, histogram, scatter),
           the bound (8 B a column of a live slot read + 8 B a column of a
           slot written), the passes' floor (`radix_floor_bytes`) and the
           copy yardstick (copy_ of the live slots' [2, n] uint32 records:
           what one pass must move, at the card's attainable rate); then
           the same with the depth column K1 wrote (three columns,
           `check_radix_three_column`), tile and index equal to the
           two-column sort's.  The depth order
           (`check_depth_order`) on the frame's own K7 rows and scan five
           times (equal results) and against its plain version bit for
           bit, its input unchanged; its time, the plain version's, the
           stable torch.sort of the depth keys (library_ms), its kernels by
           kind (prep, scatter, scan), the bound (36 B a row and 20 B a
           kept row) and the passes' floor (`depth_order_floor_bytes`).
           The scatter's phases come from
           `radix_phases`, run by hand (an instrumented build of radix.cu):
           per pass the µs of each step a partition, the look-back's
           length, staged_ahead_share, stage_wait_us and
           partitions_per_block
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
           passes, first sort, merges, last merge); each pass alone with
           CUDA events (`bitonic_pass_ms`): the first sort, the merges and
           the global passes by their kernel (register or wide) and number
           of distances; the global
           passes and stages a sort (LAUNCHES' "bitonic_register",
           "bitonic_wide" and "bitonic_global_stages"); ptxas's registers, spills and stack of every
           bitonic kernel, any spill or stack failing the phase
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
           K1' (garden, `expand_elements` under the prefilter) as K1
           above; K7 as above on garden's
           prefiltered frame, with its live thresholds; the radix sort on
           the last frame's list as above; the capped
           image against the uncapped K2 frame of the same camera within
           ±1 8-bit on r, g and b; ok true on the last timed frame
  app      the app path at garden30k_1080p's size and calibrated scale:
           write_gaussian_ply (~1.38 GB, a temporary directory), then
           load_gaussians through the native parser (ply_load_s, the
           parser from its log line), its table bit for bit with the numpy
           parser's; the CLI on the card (--ply, 1920x1080, 3 frames, --out:
           K7, K1, the radix sort and K2 once a frame, the sort's
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
import sys
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
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES
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
# 12, rot 16, opacity 4; the SH row's 192 only where its count is above 0),
# and what it writes (the six int32 column rows 24, the inclusive scan 8,
# the frame data 48); in the counts mode it reads position, scale and rot,
# and writes only the total.  Its float32 operations (a multiply-add counts
# 2), as csrc/keygen.cu writes them: view transform 18, NDC 14, depth 3,
# rotation 54, R S 9, W R S 45, the Jacobian 13, J A 18, covariance 17,
# screen 6, extents 21, inverse 4; where the count is above 0, direction
# 12, SH basis 30, SH dot 96, colour 6.
KEYGEN_READ_BYTES = 44
KEYGEN_SH_BYTES = 192
KEYGEN_WRITE_BYTES = 80
KEYGEN_COUNT_BYTES = 40
KEYGEN_FLOPS = 222
KEYGEN_SH_FLOPS = 144
# K7's floats against its plain version: at most 1 ulp apart, on at most
# this share of a column's values, each at an _fma tie of the plain version.
KEYGEN_MAX_ULP = 1
KEYGEN_MAX_FRAC = 1e-6

# The kernel launches each path is checked for: keys of `_build.LAUNCHES`,
# but for "bitonic_sort", a bitonic sort (its one first pass).
COUNTERS = (
    "expand_rows", "expand_rows_streamed", "blend_tiles", "blend_flat", "compact_slabs",
    "compact_runs", "compact_segments", "blend_strip", "bitonic_sort", "keygen_project",
    # K7 in its counts mode (count_live_elements): the steady switch's probe.
    "keygen_count", "radix_sort",
    # keygen's rows put in depth order (the radix path's keygen, once a frame).
    "depth_order",
    # radix sorts with no depth column (the uncapped radix frame's, once a frame).
    "radix_two_column",
    # depth orders whose word's h field is narrower than the grid's height
    # (the native frame's, once a frame; none at 720p and 1080p).
    "depth_order_wide",
)


def reset_counts() -> None:
    LAUNCHES.clear()


def read_counts() -> dict:
    return {k: LAUNCHES["bitonic_first" if k == "bitonic_sort" else k] for k in COUNTERS}


def read_kernels() -> dict:
    """The kernels the sorts launched."""
    return {"bitonic_sort": sum(LAUNCHES[k] for k in bitonic_kernel.COUNTER_KEYS.values()),
            "radix_sort": LAUNCHES["radix_kernels"]}


def call_plan(call) -> tuple[int, bool, str]:
    """(num_tiles, counted, key) of a captured radix_sort call."""
    (_tile, _depth, _index, count, num_tiles), kw = call
    return num_tiles, count is not None, kw.get("key", "tile_depth")


def check_radix_kernels(what: str, plan: tuple[int, bool, str], sorts: int, kernels: int,
                        depth_orders: int = 0) -> float:
    """The radix kernels on a path, `kernels` over `sorts` sorts and
    `depth_orders` row orders, against the plan (radix_kernel.planned_kernels
    for `plan`, the num_tiles, whether a count bounds the sort and its key;
    radix_kernel.DEPTH_ORDER_KERNELS a row order).  Returns the sort's
    kernels a sort."""
    planned = radix_kernel.planned_kernels(*plan)
    rows = depth_orders * radix_kernel.DEPTH_ORDER_KERNELS
    if not sorts or kernels != sorts * planned + rows:
        raise RuntimeError(f"{what}: {sorts} radix sorts and {depth_orders} depth orders "
                           f"launched {kernels} kernels, not {planned} a sort and "
                           f"{radix_kernel.DEPTH_ORDER_KERNELS} a depth order")
    return (kernels - rows) / sorts


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
    return table, config, first_pose(config), target, frames


def first_pose(config: RenderConfig) -> Camera:
    """The scenes' camera before its first frame."""
    cam = Camera(config.aspect)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(math.pi, 0.0)
    return cam


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
        (expand_kernel, "expand_elements"),
        (blend_ops, "blend_tiles"),
        (blend_ops, "pack_feature_table"),
        (blend_ops, "blend_flat"),
        (blend_ops, "blend_strip"),
        (compact_kernel, "compact_slabs"),
        (capped_ops, "capped_finish"),
        (bitonic_ops, "sort_elements_bitonic"),
        (keygen_kernel, "project_gaussians"),
        (radix_kernel, "radix_sort"),
        (radix_kernel, "depth_order"),
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


def expand_bound(cols: torch.Tensor, cum: torch.Tensor, capacity: int) -> dict:
    """keygen's expansion's bound: the scan read, the six column values of
    the rows that own a live slot read once, the three [E] int64 columns of
    the sort elements and the count written."""
    counts = counts_of(cum)
    owning = int(((counts > 0) & (cum - counts < capacity)).sum())
    ncols, n = cols.shape
    return bound(4 * ncols * owning + 8 * n + 24 * capacity + 8, 0)


def counts_of(cum: torch.Tensor) -> torch.Tensor:
    """The counts an inclusive scan sums."""
    return torch.diff(cum, prepend=cum.new_zeros(1))


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
    pairs (what a warp of two pixel rows must step through),
    "warp_steps_masked": the steps of K2's warps (8x4 pixels,
    blend_ops.WARP_PIXELS) through the rows that have the warp's bit in
    their mask (blend_ops.warp_masks_plain) while a pixel of the warp still
    needs pairs, "longest": the
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
    warp_steps_masked = torch.zeros((), dtype=torch.int64, device=device)
    warp_bits = torch.arange(p // 32, device=device)
    warp_pixels = blend_ops.WARP_PIXELS.to(device)
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
        mask = blend_ops.warp_masks_plain(torch.cat([row[:, :9], galpha], dim=1), tiles[act],
                                          config)
        warp_todo = todo[:, warp_pixels].any(dim=2)
        warp_steps_masked += (warp_todo & ((mask[:, None].long() >> warp_bits) & 1).bool()).sum()
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
            "warp_steps_masked": int(warp_steps_masked),
            "longest": int(per_tile.max()) if num_tiles else 0,
            "pairs_batch": n_batch, "eligible_past": int(eligible_past.sum()),
            "ops_batch": ops + FLOPS_PER_PAIR * (n_batch - n_pairs)
            + FLOPS_PER_T_STEP * int(eligible_past.sum()),
            "slots_batch": int(per_tile_batch.sum()), "rows_batch": distinct_rows(per_tile_batch)}


# Clock cycles (~1 ms on the H100) of the spin kernel that opens a
# profiled window.
SETTLE_CYCLES = 2_000_000


def _profile(fn, iters: int):
    """torch.profiler's CUDA kernels over `iters` calls of `fn` after one
    warm-up: (name, device ms summed, launches) of each kernel.  The window
    opens with `SETTLE_CYCLES` of spin, as in `device_ops`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SETTLE_CYCLES)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in prof.key_averages()
            if ev.self_device_time_total > 0 and "spin_kernel" not in ev.key]


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


def host_us(fn, iters: int = 50) -> float:
    """Host µs a call of `fn` takes to return (its enqueue), the device not
    waited on inside the window."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


# Windows `device_ops` takes again when its `need` is missing.
DEVICE_OPS_RETAKES = 3


def device_ops(fn, need: str | None = None) -> list[str]:
    """The device activities (kernels, memsets, copies) of one call of
    `fn`, in the order they started, from torch.profiler's CUDA trace.
    The trace can lose the first activities after it starts (a pass's
    first one or two, on the H100), so a spin kernel of `SETTLE_CYCLES`,
    waited on and left out of the result, goes first.  With `need`, a
    window in which no activity's name holds it calls `fn` again under a
    new window, with one more spin kernel before it each time, up to
    DEVICE_OPS_RETAKES times (each retake logged); the last window's
    activities are returned either way."""
    for take in range(DEVICE_OPS_RETAKES + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(take + 1):
                torch.cuda._sleep(SETTLE_CYCLES)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        ops = [e.name for e in sorted(events, key=lambda e: e.time_range.start)]
        if need is None or any(need in op for op in ops):
            return ops
        if take < DEVICE_OPS_RETAKES:
            log(f"device_ops: the window lost every {need} (first ops "
                f"{[short_op(x) for x in ops[:3]]}); retake {take + 1}")
    return ops


def short_op(name: str) -> str:
    m = re.search(r"(\w+_kernel)(<[^(]*?>)?\(", name)
    return m.group(1) + (m.group(2) or "") if m else name[:48]


# A card keygen pass, device op by device op after K7's full launch (its
# scratch memset comes just before it); on the radix path the rows' depth
# order (its scratch memset, the prep, a scatter a depth digit, the scan)
# comes between K7 and K1.
KEYGEN_PASS = ("partition_kernel", "expand_rows_kernel")
K7_KERNEL = "keygen_project_kernel"
DEPTH_ORDER_PASS = ("Memset", "radix_rows_prep_kernel",
                    *["radix_scatter_kernel"] * radix_kernel.DEPTH_PASSES,
                    "radix_rows_scan_kernel")


def check_keygen_pass(ops: list[str], what: str, depth_order: bool = False) -> list[str]:
    """Every full K7 launch among `ops` (a profiled window's device ops) is
    followed at once by K1's partition kernel and K1's expansion, which
    stores the sort elements, or with `depth_order` by the rows' depth
    order and then K1: no PyTorch kernel, memset or copy between them.
    Raises otherwise, or if the window holds no full K7 launch; returns the
    last pass's ops, from the one before K7 to K1's expansion."""
    want = (DEPTH_ORDER_PASS if depth_order else ()) + KEYGEN_PASS
    full = [j for j, op in enumerate(ops) if K7_KERNEL in op]
    if not full:
        raise RuntimeError(f"{what}: the profiler saw no full K7 launch in "
                           f"{[short_op(x) for x in ops]}")
    for j in full:
        after = [short_op(x) for x in ops[j + 1: j + 1 + len(want)]]
        if [re.sub(r"<.*| .*", "", x) for x in after] != list(want):
            raise RuntimeError(f"{what}: K7 is followed by {after}, not {list(want)}")
    j = full[-1]
    return [short_op(x) for x in ops[max(j - 1, 0): j + 1 + len(want)]]


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
UNCAPPED_PATH = ("keygen_project", "depth_order", "expand_rows", "radix_sort", "radix_two_column",
                 "blend_tiles")
BITONIC_PATH = tuple(k for k in UNCAPPED_PATH
                     if k not in ("depth_order", "radix_sort", "radix_two_column")) + (
                         "bitonic_sort",)


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
                                        counts["radix_sort"], read_kernels()["radix_sort"],
                                        counts["depth_order"])
    if any(v != drawn for v in launches.values()) or counts["depth_order_wide"]:
        raise RuntimeError(f"{name}: K7, the depth order, K1, the radix sort and K2 must launch "
                           f"once a frame, {drawn} frames, and no depth order take the wide "
                           f"record: {launches}, {counts['depth_order_wide']} wide")
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
    # One more frame at the last camera, under the profiler.
    keygen_pass = check_keygen_pass(device_ops(lambda: renderer.draw(cam), K7_KERNEL), name,
                                    depth_order=True)
    log(f"scene {name}: {table.num_gaussians} gaussians, capacity "
        f"{renderer.capacity}, scale x{mult:.4f} -> {live} live (target {target}, "
        f"calibrated in {calib_s:.1f} s); last frame {int(out.num_elements)} elements; "
        f"ms/frame median {statistics.median(frame_ms):.3f} "
        f"(min {min(frame_ms):.3f}, max {max(frame_ms):.3f}, {frames} frames); per pass ms "
        + ", ".join(f"{k} {passes[k]:.3f}" for k in ("keygen", "expand", "sort", "ranges", "blend"))
        + f"; launches {launches}, {radix_kernels:g} kernels a radix sort; feature tables built "
        f"{tables}; torch.sort/argsort calls in the {WARMUP_FRAMES} warm-up frames {sorts.calls}; "
        f"a keygen pass's device ops {keygen_pass}")
    per_frame = {k: v / drawn for k, v in counts.items()}
    return renderer, cam, cap.args, launches, mult, per_frame, passes, radix_kernels


def check_elements_vs_cpu(renderer: Renderer, cam: Camera) -> None:
    """keygen + sort + ranges of the last frame, the frame's way (rows in
    depth order, the tile key) and in index order on the full key: card ==
    CPU, bit for bit, and the two ways equal."""
    view, proj = cam.matrices()
    results = []
    for depth_first in (True, False):
        for table in (renderer.table, renderer.table.to("cpu")):
            el, _ = keygen.generate_sort_elements(
                table, view, proj, cam.position, renderer.config, renderer.capacity,
                depth_order=depth_first,
            )
            el = sort.sort_elements(el, renderer.config, depth_ordered=depth_first)
            results.append((el, ranges.find_ranges(el, renderer.config.num_tiles)))
    (ge, gr), *others = results
    for what, (ce, cr) in zip(("CPU", "index order on the card", "index order on the CPU"),
                              others):
        bad = {k: int((getattr(ge, k).cpu() != getattr(ce, k).cpu()).sum())
               for k in ("tile", "depth", "index")}
        bad["ranges"] = int((gr.cpu() != cr.cpu()).sum())
        bad["count"] = int(ge.count) - int(ce.count)
        if any(bad.values()):
            raise RuntimeError(f"card's depth-first frame vs {what}: element mismatch {bad}")
    log(f"check: keygen/sort/ranges card == CPU bit for bit, depth first == index order "
        f"({int(ge.count)} elements)")


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
        counts = np.asarray(counts, np.int64)
        cols = torch.from_numpy(np.stack([
            np.arange(n, dtype=np.int32),
            rng.integers(-(2**31), 2**31, size=n).astype(np.int32),
        ])).cuda()
        c = torch.cumsum(torch.from_numpy(counts).cuda(), 0)
        got, total = expand_kernel.expand_rows(cols, c, capacity)
        want, want_total = expand_kernel.expand_rows_plain(cols, c, capacity)
        if not torch.equal(got, want) or int(total) != int(want_total):
            raise RuntimeError(f"expand_rows edge case (n={n}, capacity={capacity}) differs")
        # keygen's six rows: id, clamped offset, max(w, 1), min_x, min_y, depth bits.
        rows = torch.from_numpy(np.stack([
            np.arange(n), np.minimum(np.cumsum(counts) - counts, capacity),
            rng.integers(1, 120, size=n), rng.integers(0, 120, size=n),
            rng.integers(0, 68, size=n), rng.integers(-(2**31), 2**31, size=n),
        ]).astype(np.int32)).cuda()
        for streamed in (False, True):
            got_el = expand_kernel.expand_elements(rows, c, capacity, 120, streamed=streamed)
            want_el = expand_kernel.expand_elements_plain(rows, c, capacity, 120)
            if not all(torch.equal(a, b) for a, b in zip(got_el, want_el)):
                raise RuntimeError(f"expand_elements edge case (n={n}, capacity={capacity}, "
                                   f"streamed={streamed}) differs")
    log(f"check: expand_rows and expand_elements bit-exact on {len(cases)} edge cases (a "
        f"12,000-slot gaussian, 1.1M zero counts, E % 4 != 0, total > E, N = 0)")


def torch_sort_elements(el, num_tiles: int, with_perm: bool = False, key: str = "tile_depth"):
    """The stable int64-key torch.sort that the AUTO sort replaced (on the
    tile alone for the "tile" key): the radix sort's library yardstick
    (library_ms) and a reference here; no module of the port calls it."""
    tile = torch.where(el.tile == SENTINEL, num_tiles, el.tile)
    _, perm = torch.sort(tile if key == "tile" else (tile << 32) | el.depth, stable=True)
    out = keygen.SortElements(el.tile[perm], None if el.depth is None else el.depth[perm],
                              el.index[perm], el.count)
    return (out, perm) if with_perm else out


def radix_floor_bytes(n: int, e: int, num_tiles: int, counted: bool, with_perm: bool,
                      key: str = "tile_depth", cols: int = 3) -> int:
    """The bytes csrc/radix.cu's kernels move for n sorted slots of e with
    records of `cols` columns (3: depth, tile', payload; 2: no depth): the
    setup reads and writes the tail's columns (and its permutation); the
    histogram reads the int64 depth (the full key) and tile of the prefix
    once and zeroes the status words (passes x partitions x 256 x 4 B); a
    scatter reads and writes the 4 B a column records (the first reads the
    int64 columns, the index only without the permutation; the last writes
    the int64 columns and the permutation, whose index it gathers), and
    each live partition writes its 256 status words twice and reads 1 KB of
    its predecessor's and the 1 KB digit table."""
    passes = len(radix_kernel.schedule(num_tiles, key))
    parts, live_parts = -(-e // radix_kernel.TILE), -(-n // radix_kernel.TILE)
    tail = (16 * cols + 8 * with_perm) * (e - n) if counted else 0
    hist = (8 if key == "tile" else 16) * n + 4 * radix_kernel.BINS * passes * parts
    scatter = (8 * cols - 8 * with_perm) * n + 8 * cols * n * (passes - 1) + 8 * cols * n
    lookback = 4 * 4 * radix_kernel.BINS * passes * live_parts
    return tail + hist + scatter + 16 * n * with_perm + lookback


def copy_yardstick_ms(n: int, cols: int = 3) -> float:
    """A device copy of n records of `cols` uint32 columns (`copy_` of a
    [cols, n] uint32 buffer): the card's attainable rate for what one
    scatter pass must read and write."""
    src = torch.empty((cols, n), dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    return cuda_ms(lambda: dst.copy_(src), 20)


RADIX_REPEATS = 5


def _same(a: torch.Tensor | None, b: torch.Tensor | None) -> bool:
    """Equal columns, or both absent (a sort's depth without the column)."""
    return a is b is None or (a is not None and b is not None and torch.equal(a, b))


def check_radix(call, what: str, timed: bool = True) -> dict:
    """The radix sort on one call's own inputs, RADIX_REPEATS times with
    equal results (a look-back ordering fault shows as a run that
    differs), against its plain version and the stable torch.sort, bit for
    bit (the permutation too; the depth where the call carries one), its
    input unchanged; with `timed`, its times, its floor and bound, and the
    copy yardstick."""
    (tile, depth, index, count, num_tiles), kw = call
    with_perm = kw.get("with_perm", False)
    key = kw.get("key", "tile_depth")
    cols = 2 if depth is None else 3
    el = keygen.SortElements(tile, depth, index, count)
    before = [x.clone() for x in el[:3] if x is not None]
    kernels = LAUNCHES["radix_kernels"]
    got = radix_kernel.radix_sort(tile, depth, index, count, num_tiles, with_perm=with_perm,
                                  key=key)
    kernels = check_radix_kernels(what, call_plan(call), 1, LAUNCHES["radix_kernels"] - kernels)
    for k in range(1, RADIX_REPEATS):
        again = radix_kernel.radix_sort(tile, depth, index, count, num_tiles, with_perm=with_perm,
                                        key=key)
        if not all(_same(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{what}: radix_sort run {k} differs from run 0 on the same list")
    del again
    refs = {"plain version": sort.sort_elements_radix_plain(el, num_tiles, with_perm=with_perm,
                                                            key=key),
            "stable torch.sort": torch_sort_elements(el, num_tiles, with_perm, key)}
    for ref_name, ref in refs.items():
        ref_cols = [*ref[0][:3], ref[1]] if with_perm else list(ref[:3])
        for col, a, b in zip(("tile", "depth", "index", "permutation"), got, ref_cols):
            if not _same(a, b):
                at = "" if a is None or b is None else f" at {int((a != b).sum())} slots"
                raise RuntimeError(f"{what}: radix_sort differs from the {ref_name} in {col}{at}")
    plain = refs["plain version"]
    plain_cols = [*plain[0][:3], plain[1]] if with_perm else list(plain[:3])
    err = max((int((a - b).abs().max()) for a, b in zip(got, plain_cols)
               if a is not None and a.numel()), default=0)
    if not all(torch.equal(a, b) for a, b in zip(before, (x for x in el[:3] if x is not None))):
        raise RuntimeError(f"{what}: radix_sort wrote its input")
    e = tile.shape[0]
    n = e if count is None else min(max(int(count), 0), e)
    res = {"max_abs_err": err, "e": e, "live": n, "with_perm": with_perm, "key": key,
           "columns": cols}
    if not timed:
        return res
    del refs, plain, plain_cols, got
    passes = len(radix_kernel.schedule(num_tiles, key))

    def run():
        return radix_kernel.radix_sort(tile, depth, index, count, num_tiles, with_perm=with_perm,
                                       key=key)

    res.update({
        "ms": cuda_ms(run, 20),
        "plain_ms": cuda_ms(lambda: sort.sort_elements_radix_plain(el, num_tiles,
                                                                   with_perm=with_perm, key=key),
                            1),
        "library_ms": cuda_ms(lambda: torch_sort_elements(el, num_tiles, with_perm, key), 10),
        "device_ms": device_kinds(run, {"setup": r"radix_setup", "histogram": r"radix_histogram",
                                        "scatter": r"radix_scatter"}),
        "digit_passes": passes,
        # The function: 8 B a column of a live slot read, 8 B a column of a
        # slot written (and the permutation's 8), the count.
        **bound(8 * cols * n + (8 * cols + 8 * with_perm) * e + 8, 0),
        "passes_floor_ms": radix_floor_bytes(n, e, num_tiles, count is not None, with_perm, key,
                                             cols) / PEAK_BYTES_PER_S * 1e3,
        "copy_ms": copy_yardstick_ms(n, cols),
    })
    scatter = res["device_ms"].get("scatter", {}).get("ms", float("nan"))
    res["scatter_pass_ms"] = scatter / passes
    log(f"check {what} radix: radix_sort x{RADIX_REPEATS} equal, == plain == stable torch.sort "
        f"bit for bit ({n} sorted of {e} slots, key {key}, {cols} columns, {passes} digit "
        f"passes, {kernels:g} kernels"
        f"{', with the permutation' if with_perm else ''}), its input unchanged; kernel "
        f"{res['ms']:.3f} ms vs plain {res['plain_ms']:.3f} ms, torch.sort "
        f"{res['library_ms']:.3f} ms; by kind {res['device_ms']}; bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}, {res['bound_bytes']} B), the passes' floor "
        f"{res['passes_floor_ms']:.4f} ms; yardstick copy_ of [{cols}, {n}] uint32 "
        f"{res['copy_ms']:.4f} ms, a scatter pass {res['scatter_pass_ms']:.4f} ms "
        f"({res['copy_ms'] / res['scatter_pass_ms']:.0%} of the copy's rate)")
    return res


def three_column_call(args) -> tuple:
    """The uncapped frame's tile-key sort call (two columns: its depth is
    None) with the depth column it left out, rebuilt by K1 on the frame's
    own rows and scan (`expand_elements`, whose tile and index must be the
    call's)."""
    (tile, depth, index, count, num_tiles), kw = args["radix_sort"]
    if depth is not None:
        raise RuntimeError("the uncapped radix frame's sort carried a depth column")
    (cols, cum, capacity, grid_w), kx = args["expand_elements"]
    k1_tile, k1_depth, k1_index, _count = expand_kernel.expand_elements(cols, cum, capacity,
                                                                        grid_w, **kx)
    if not (torch.equal(k1_tile, tile) and torch.equal(k1_index, index)):
        raise RuntimeError("K1 rerun on the frame's rows differs from the frame's sort input")
    return (tile, k1_depth, index, count, num_tiles), kw


def check_radix_three_column(args, what: str, two: dict) -> dict:
    """The frame's tile-key sort with three columns beside its own two
    (`two`, `check_radix` on the frame's call): tile and index bit for bit,
    and its `check_radix` times in the same process."""
    call = three_column_call(args)
    (tile, depth, index, count, num_tiles), kw = call
    got3 = radix_kernel.radix_sort(tile, depth, index, count, num_tiles, **kw)
    got2 = radix_kernel.radix_sort(tile, None, index, count, num_tiles, **kw)
    if got2[1] is not None or not all(torch.equal(got2[k], got3[k]) for k in (0, 2)):
        raise RuntimeError(f"{what}: the two-column sort's tile and index differ from the "
                           "three-column sort's")
    del got2, got3
    three = check_radix(call, f"{what} three columns")
    log(f"check {what} radix columns: two == three in tile and index bit for bit; two columns "
        f"{two['ms']:.4f} ms (scatters {two['device_ms'].get('scatter')}), three "
        f"{three['ms']:.4f} ms (scatters {three['device_ms'].get('scatter')}); floors "
        f"{two['passes_floor_ms']:.4f} / {three['passes_floor_ms']:.4f} ms")
    return three


def depth_order_floor_bytes(n: int, m: int) -> int:
    """The bytes csrc/radix.cu's depth order moves for n rows, m of them
    kept: the prep reads max(w, 1), min_x, min_y, the depth bits and the
    scan (24 B a row), writes the kept rows' 12-byte records and zeroes the
    status words; four scatters read and write the records (the last writes
    six int32 columns, 24 B a kept row); the scan reads the kept counts and
    writes the int64 scan and the offsets (12 B a row); each live partition
    of a pass writes its 256 status words twice and reads 1 KB of its
    predecessor's and the 1 KB digit table."""
    passes = radix_kernel.DEPTH_PASSES
    parts, live_parts = -(-n // radix_kernel.TILE), -(-m // radix_kernel.TILE)
    row_parts = -(-n // radix_kernel.ROW_TILE)
    prep = 24 * n + 12 * m + 4 * radix_kernel.BINS * passes * parts + 8 * row_parts
    scatter = 12 * m * passes + 12 * m * (passes - 1) + 24 * m
    scan = 4 * m + 12 * n
    lookback = 4 * 4 * radix_kernel.BINS * passes * live_parts
    return prep + scatter + scan + lookback


def check_depth_order(call, what: str) -> dict:
    """keygen's row order (`radix_kernel.depth_order`) on the frame's own K7
    rows and scan, RADIX_REPEATS times with equal results, against its
    plain version bit for bit (the kept rows' columns, every offset, the
    scan), its input unchanged; its time, the plain version's, the stable
    torch.sort of the rows' depth keys (library_ms), its kernels by kind,
    its bound (the rows' four columns and the scan read, 24 B a row; the
    offsets and the scan written, 12 B a row, and the kept rows' five other
    columns, 20 B) and its passes' floor (`depth_order_floor_bytes`)."""
    (cols, cum, capacity, grid_w, grid_h), _kw = call
    before = (cols.clone(), cum.clone())

    def run():
        return radix_kernel.depth_order(cols, cum, capacity, grid_w, grid_h)

    got = run()
    end = cum.clamp(max=capacity)
    m = int((counts_of(end) > 0).sum())
    for k in range(1, RADIX_REPEATS):
        again = run()
        if not (torch.equal(again[1], got[1]) and torch.equal(again[0][:, :m], got[0][:, :m])
                and torch.equal(again[0][1], got[0][1])):
            raise RuntimeError(f"{what}: depth_order run {k} differs from run 0 on the same rows")
    want = radix_kernel.depth_order_plain(cols, cum, capacity)
    if not (torch.equal(got[1], want[1]) and torch.equal(got[0][:, :m], want[0][:, :m])
            and torch.equal(got[0][1], want[0][1])):
        raise RuntimeError(f"{what}: depth_order differs from its plain version")
    if not (torch.equal(before[0], cols) and torch.equal(before[1], cum)):
        raise RuntimeError(f"{what}: depth_order wrote its input")
    n = cols.shape[1]
    keys = cols[5].to(torch.int64) & 0xFFFFFFFF
    res = {
        "max_abs_err": 0, "rows": n, "kept_rows": m, "capacity": capacity,
        "ms": cuda_ms(run, 20),
        "plain_ms": cuda_ms(lambda: radix_kernel.depth_order_plain(cols, cum, capacity), 1),
        "library_ms": cuda_ms(lambda: torch.sort(keys, stable=True), 10),
        "device_ms": device_kinds(run, {"prep": r"rows_prep", "scatter": r"radix_scatter",
                                        "scan": r"rows_scan"}),
        **bound(36 * n + 20 * m, 0),
        "passes_floor_ms": depth_order_floor_bytes(n, m) / PEAK_BYTES_PER_S * 1e3,
    }
    log(f"check {what} depth order: x{RADIX_REPEATS} equal, == plain bit for bit ({m} kept of "
        f"{n} rows, capacity {capacity}), its input unchanged; kernel {res['ms']:.3f} ms vs plain "
        f"{res['plain_ms']:.3f} ms, torch.sort of the depth keys {res['library_ms']:.3f} ms; by "
        f"kind {res['device_ms']}; bound {res['bound_ms']:.4f} ms ({res['bound_bytes']} B), the "
        f"passes' floor {res['passes_floor_ms']:.4f} ms")
    return res


# The scatter's phases as csrc/radix.cu's instrumented build stamps them
# (vk3d_radix_phases): slot pairs of thread 0's clock, in the order of the
# block's loop (the global ns at slots 0 and 9); then the slots of bin 0's
# look-back words, of the block's index times 2 plus 1 if the partition was
# staged ahead, and of the cycles its block waited for its stage.
RADIX_PHASES = {"rank": (1, 2), "issue next": (2, 3), "scans": (3, 4), "inverse map": (4, 5),
                "next's wait and count": (5, 6), "look-back": (6, 7), "stores": (7, 8)}
RADIX_PHASE_SLOTS = 13
RADIX_PHASE_STEPS, RADIX_PHASE_BLOCK, RADIX_PHASE_WAIT = 10, 11, 12


def radix_phases(call, what: str) -> list[dict]:
    """The radix sort of one call's inputs through a second library, built
    from csrc/radix.cu alone with -DVK3D_RADIX_PHASES=1 (a measurement run
    by hand; main() does not call it), whose scatter stamps each
    partition's phases: per pass the mean µs of each phase a partition (the
    block's clock over its cycles per ns), the pass's span, the blocks
    busy on average, bin 0's look-back length, the share of partitions
    staged ahead (their copy issued before their block's previous
    partition ended), the µs a partition's block waited for its stage
    (`stage_wait_us`) and the partitions a block took.  Its result must
    equal the port's kernel's."""
    (tile, depth, index, count, num_tiles), kw = call
    with_perm = kw.get("with_perm", False)
    key = kw.get("key", "tile_depth")
    lib = ctypes.CDLL(str(_build.build(("-DVK3D_RADIX_PHASES=1",), stems=("radix",))))
    lib.vk3d_radix_sort.argtypes, lib.vk3d_radix_sort.restype = _build.SIGNATURES["vk3d_radix_sort"]
    lib.vk3d_radix_phases.argtypes, lib.vk3d_radix_phases.restype = [ctypes.c_void_p], ctypes.c_int
    e = tile.shape[0]
    out = [None if x is None else torch.empty_like(x)
           for x in (tile, depth, index, *([tile] if with_perm else []))]
    scratch = torch.empty(radix_kernel.scratch_words(e, num_tiles, key), dtype=torch.int32,
                          device=tile.device)
    launched = ctypes.c_int64(0)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.vk3d_radix_sort(
        *(ptr(x) for x in (tile, depth, index, count)), e, num_tiles,
        radix_kernel.SORT_KEYS[key], scratch.data_ptr(), *(ptr(x) for x in out[:3]),
        out[3].data_ptr() if with_perm else None,
        ctypes.byref(launched), tile.device.index, torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.cuda_error(err, "radix_sort (phases build)")
    want = radix_kernel.radix_sort(tile, depth, index, count, num_tiles, with_perm=with_perm,
                                   key=key)
    if not all(_same(a, b) for a, b in zip(out, want)):
        raise RuntimeError(f"{what}: the phases build of the radix sort differs from the kernel")
    stamps = np.zeros((radix_kernel.MAX_PASSES, 4096, RADIX_PHASE_SLOTS), np.uint64)
    err = lib.vk3d_radix_phases(stamps.ctypes.data)
    if err:
        raise _build.cuda_error(err, "vk3d_radix_phases")
    n = e if count is None else min(max(int(count), 0), e)
    parts = min(-(-n // radix_kernel.TILE), 4096)
    rows = []
    for q in range(len(radix_kernel.schedule(num_tiles, key))):
        b = stamps[q, :parts].astype(np.int64)
        ns = b[:, 9] - b[:, 0]
        per_ns = (b[:, 8] - b[:, 1]).sum() / ns.sum()
        span_us = (b[:, 9].max() - b[:, 0].min()) / 1e3
        block = b[:, RADIX_PHASE_BLOCK]
        rows.append({
            "pass": q, "span_us": round(float(span_us), 2),
            "busy_blocks": round(float(ns.sum() / 1e3 / span_us), 1),
            "partition_us": round(float(ns.mean() / 1e3), 2),
            **{k: round(float((b[:, hi] - b[:, lo]).mean() / per_ns / 1e3), 2)
               for k, (lo, hi) in RADIX_PHASES.items()},
            "look_back_words": round(float(b[1:, RADIX_PHASE_STEPS].mean()), 1),
            "staged_ahead_share": round(float((block & 1).mean()), 4),
            "stage_wait_us": round(float(b[:, RADIX_PHASE_WAIT].mean() / per_ns / 1e3), 2),
            "partitions_per_block": round(parts / len(np.unique(block >> 1)), 2),
        })
    log(f"radix phases {what} ({n} sorted, {parts} partitions, {3 if depth is not None else 2} "
        f"columns; instrumented build, µs a partition): {rows}")
    return rows


def check_radix_edge_cases() -> None:
    """The radix sort on lists built to hit its edges, against its plain
    version and the stable torch.sort (`check_radix`), each on its key and
    on the tile key without the depth column, then two different
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
        # The tile key without the depth column: two-column records.
        check_radix(((t[0], None, t[2], c, num_tiles), {"with_perm": with_perm, "key": "tile"}),
                    f"radix edge case {what}, two columns", timed=False)
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
        f"{len(cases)} edge cases, on the full key and on the tile key with two columns "
        f"({', '.join(cases)}; interleaved: {inter_live} live of 70,001), "
        f"inputs unchanged; two {size}-slot lists back to back == torch.sort")


def check_radix_ptxas() -> list[str]:
    """ptxas on the radix sort's kernels (the setup, the histogram of each
    key, nine scatter instantiations: first, last, both or neither with
    three and with two columns, and the rows' last pass; the rows' prep and
    scan): no spills and no stack, or the run fails; and the kernel's
    constants against the wrapper's copies."""
    config = radix_kernel.check_kernel_config()
    entries = [" ".join(x) for x in ptxas_report() if x[0].startswith("radix_")]
    if len(entries) != 14:
        raise RuntimeError(f"ptxas reported {len(entries)} radix kernels, not 14: {entries}")
    for entry in entries:
        if re.search(r"[1-9]\d* bytes (stack frame|spill)", entry):
            raise RuntimeError(f"radix kernel spills or uses a stack: {entry}")
    log(f"check: ptxas on the radix kernels, no spill and no stack: {' | '.join(entries)}; "
        f"csrc/radix.cu's constants == radix_kernel's: {config}")
    return entries


def check_expansion(call, what: str) -> dict:
    """keygen's expansion (`expand_elements`: K1, or K1' under the
    prefilter) on one call's own inputs (K7's rows and scan) against its
    plain version, decode_slots_plain over expand_rows_plain: tile, depth,
    index and the count bit for bit.  Its time, the plain version's, its
    kernels from the profiler and its bound.  No one PyTorch call computes
    the same function, so no library time."""
    (cols, cum, capacity, grid_w), kw = call

    def kernel():
        return expand_kernel.expand_elements(cols, cum, capacity, grid_w, **kw)

    got = kernel()
    want = expand_kernel.expand_elements_plain(cols, cum, capacity, grid_w)
    for col, a, b in zip(("tile", "depth", "index", "count"), got, want):
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: expand_elements differs from its plain version in {col} "
                               f"at {int((a != b).sum())} values")
    return {
        "max_abs_err": 0,
        "live": int(want[3]),
        "capacity": capacity,
        "ms": cuda_ms(kernel, 20),
        "plain_ms": cuda_ms(lambda: expand_kernel.expand_elements_plain(cols, cum, capacity,
                                                                        grid_w), 3),
        "library_ms": None,
        "device_ms": device_breakdown(kernel),
        **expand_bound(cols, cum, capacity),
    }


def check_kernels(args, config: RenderConfig, name: str, passes: dict) -> dict:
    """Each kernel against its plain version on the frame's own inputs, with
    its bound and the library call's time."""
    k1 = check_expansion(args["expand_elements"], name)

    (elements, rng_, frame, _cfg), _ = args["blend_tiles"]
    img = blend_ops.blend_tiles(elements, rng_, frame, config)
    table = blend_ops.pack_feature_table(frame)
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
        "ms": cuda_ms(lambda: blend_ops.blend_tiles(elements, rng_, frame, config), 20),
        "plain_ms": cuda_ms(lambda: blend_ops.blend_rows_plain(
            blend_ops.pack_feature_table(frame), elements.index, rng_, config), 1),
        "library_ms": None,
        "blend_section_ms": passes["blend"],
        "work": work,
        **bound(8 * work["slots"] + FRAME_ROW_BYTES * work["rows"] + 16 * config.num_tiles
                + 12 * config.width * config.height, work["ops"]),
    }
    log(f"check {name}: expand_elements == plain bit for bit ({k1['live']} live of "
        f"{k1['capacity']}, on K7's rows and scan), kernel {k1['ms']:.3f} ms vs plain "
        f"{k1['plain_ms']:.3f} ms, kernels {k1['device_ms']}, bound {k1['bound_ms']:.4f} ms "
        f"({k1['bound_by']}, {k1['bound_bytes']} B); blend_tiles float max |Δ| {k2['max_abs_err']:.3e}, 8-bit "
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
    """K7 against its plain version on one call's own inputs: the packed
    rows (the clamped offset row too), the scan `cum`, the total, extents
    and the visible / keep flags bit for bit; each float column within
    KEYGEN_MAX_ULP on at most KEYGEN_MAX_FRAC of its values, every
    differing gaussian at an _fma tie (`fma_ties`); the counts mode's
    total, extents and flags bit for bit."""
    got = keygen_kernel.project_gaussians(*call, with_aux=True)
    want = keygen_kernel.project_gaussians_plain(*call, with_aux=True)
    bad = keygen_kernel.projection_mismatch(got, want)
    ints = {k: bad[k] for k in keygen_kernel.INT_FIELDS if bad[k]}
    if ints:
        raise RuntimeError(f"{what}: keygen_project's integer outputs differ from its plain "
                           f"version: {ints}")
    n = call[0].num_gaussians
    rows = torch.zeros(n, dtype=torch.bool, device=got.total.device)
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
    got_c = keygen_kernel.project_gaussians(*counts_call, with_aux=True)
    want_c = keygen_kernel.project_gaussians_plain(*counts_call, with_aux=True)
    bad_c = keygen_kernel.projection_mismatch(got_c, want_c)
    if any(bad_c.values()) or set(bad_c) != {"total", "extents", "flags"}:
        raise RuntimeError(f"{what}: keygen_project's counts mode differs from its plain "
                           f"version: {bad_c}")
    rows = keygen_kernel.sh_rows_read(got)
    if rows != keygen_kernel.sh_rows_read(want) or bool(
            (got.color_alpha[~keygen_kernel.emitting(got), :3] != 0).any()):
        raise RuntimeError(f"{what}: keygen_project's SH gate: {rows} rows read, the plain "
                           f"version's {keygen_kernel.sh_rows_read(want)}, or an rgb not 0 "
                           f"where the count is 0")
    return {"mismatch": {k: bad[k] for k in keygen_kernel.FLOAT_FIELDS},
            "tie_gaussians": idx.tolist()[:20], "max_abs_err": max_abs,
            "live": int(got.total), "sh_rows_read": rows, "sh_rows_share": rows / n}


def check_keygen(args, name: str, sh_modes=()) -> dict:
    """K7 against its plain version on the frame's own inputs (the last
    frame's table, camera, config and thresholds), also in each SH mode of
    `sh_modes`; times and bound."""
    call = args["project_gaussians"][0]
    table, view, proj, cam_pos, config, capacity, thr = call
    n = table.num_gaussians
    k7 = check_projection(call, f"{name} keygen_project")
    modes = {}
    for mode in sh_modes:
        c = (*call[:4], dataclasses.replace(config, sh_mode=mode), *call[5:])
        modes[mode.name] = check_projection(c, f"{name} keygen_project {mode.name}")["mismatch"]
    counts_call = (*call[:5], None, thr)
    scratch_words = _build.load_library().vk3d_keygen_scratch_words(n, config.num_tiles)
    k7.update({
        "sh_modes": modes,
        # The wrapper's host time a call, and the parts of it that are not
        # the allocations, the .contiguous() calls and the ctypes call.
        "host_us": host_us(lambda: keygen_kernel.project_gaussians(*call)),
        "host_us_params": host_us(lambda: keygen_kernel.keygen_params(*call[1:5])),
        "host_us_check": host_us(lambda: keygen_kernel._check(table, thr, config)),
        "host_us_outputs": host_us(lambda: keygen_kernel._outputs(
            n, table.position.device, scratch_words, False)),
        "ms": cuda_ms(lambda: keygen_kernel.project_gaussians(*call), 20),
        "plain_ms": cuda_ms(lambda: keygen_kernel.project_gaussians_plain(*call), 1),
        "library_ms": None,
        "count_ms": cuda_ms(lambda: keygen_kernel.project_gaussians(*counts_call), 20),
        "count_bound_ms": bound(KEYGEN_COUNT_BYTES * n, 0)["bound_ms"],
        "device_ms": device_breakdown(lambda: keygen_kernel.project_gaussians(*call)),
        # The thresholds are read once too, where the prefilter is on.
        **bound((KEYGEN_READ_BYTES + KEYGEN_WRITE_BYTES) * n
                + KEYGEN_SH_BYTES * k7["sh_rows_read"] + (8 * thr.numel() if thr is not None else 0),
                KEYGEN_FLOPS * n + KEYGEN_SH_FLOPS * k7["sh_rows_read"]),
    })

    log(f"check {name} keygen: keygen_project == plain on {n} gaussians ({k7['live']} live, "
        f"prefilter {'on' if thr is not None else 'off'}; SH rows read {k7['sh_rows_read']}, "
        f"{k7['sh_rows_share']:.4f} of N, rgb 0 elsewhere): packed rows, extents, "
        f"visible/keep bit for bit; floats (values differing, max ulp) {k7['mismatch']}, "
        f"max |Δ| {k7['max_abs_err']:.3e}, _fma-tie gaussians {k7['tie_gaussians']}"
        + "".join(f"; {m} {v}" for m, v in modes.items())
        + f"; offset row, cum and total bit for bit; counts mode (total, extents, flags) == "
        f"plain; kernel "
        f"{k7['ms']:.3f} ms vs plain {k7['plain_ms']:.3f} ms, counts mode {k7['count_ms']:.3f} ms "
        f"(bound {k7['count_bound_ms']:.4f}), host µs a call {k7['host_us']:.1f} (keygen_params "
        f"{k7['host_us_params']:.1f}, _check {k7['host_us_check']:.1f}, the outputs' "
        f"allocations {k7['host_us_outputs']:.1f}), kernels "
        f"{k7['device_ms']}, bound {k7['bound_ms']:.4f} ms ({k7['bound_by']}, "
        f"{k7['bound_bytes']} B)")
    return {"keygen_project": k7}


def k7_alone_ms(call, iters: int = 20) -> float:
    """K7's kernel alone (`keygen_project_kernel`, from the profiler), device
    ms a call, on one call's inputs."""
    for key, ms, n in _profile(lambda: keygen_kernel.project_gaussians(*call), iters):
        if "keygen_project_kernel" in key:
            return _per_call(ms, n, iters)[0]
    raise RuntimeError("the profiler saw no keygen_project_kernel")


def k7_poses(table: GaussianTable, config: RenderConfig, cam: Camera) -> dict:
    """K7 at two poses of one table: `cam`'s and one from far enough back
    on its axis that every gaussian is on the image (nothing culled, so the
    SH gate saves no byte).  At each: the SH rows K7 reads (the gaussians
    whose count is above 0, from its scan) and their share of N, the
    gaussians in view (the cull's flag), K7 alone and the wrapper.  It
    calls nothing the wrapper lacked before the SH gate, so that `ab_k7`
    can run it on a tree without the gate."""
    far = Camera(config.aspect)
    far.set_position(cam.position - cam.forward_dir * np.float32(12.0))
    far.set_rotation(cam.yaw, cam.pitch)
    n = table.num_gaussians
    out = {}
    for pose, c in (("first", cam), ("in_view", far)):
        view, proj = c.matrices()
        call = (table, view, proj, c.position, config, config.sort_capacity(n), None)
        p = keygen_kernel.project_gaussians(*call, with_aux=True)
        rows = int((counts_of(p.cum) > 0).sum())
        out[pose] = {"sh_rows_read": rows, "sh_rows_share": rows / n, "live": int(p.total),
                     "visible": int((p.flags & 1).sum()),
                     "k7_alone_ms": k7_alone_ms(call),
                     "ms": cuda_ms(lambda: keygen_kernel.project_gaussians(*call), 20)}
    return out


def check_keygen_ptxas() -> list[str]:
    """ptxas on K7 (its full and counts-mode kernels) and K1 (its partition
    search and the expansion's four variants): no spills and no stack, or
    the run fails."""
    entries = [" ".join(x) for x in ptxas_report() if x[0].startswith(
        ("keygen_project_kernel", "keygen_count_kernel", "partition_kernel",
         "expand_rows_kernel"))]
    if len(entries) != 7:
        raise RuntimeError(f"ptxas reported {len(entries)} keygen kernels, not 7: {entries}")
    for entry in entries:
        if re.search(r"[1-9]\d* bytes (stack frame|spill)", entry):
            raise RuntimeError(f"keygen kernel spills or uses a stack: {entry}")
    log(f"check: ptxas on the keygen kernels, no spill and no stack: {' | '.join(entries)}")
    return entries


# One tree's part of the frame A/B: the uncapped frames at both scenes and
# the capped frame at garden, as main() runs them.
AB_TREE = ("import chip_smoke as c\n"
           "c.phase_device()\n"
           "c.phase_build()\n"
           "mults = {n: c.run_scene(n)[4] for n in c.SCENES}\n"
           "c.run_capped('garden30k_1080p', mults['garden30k_1080p'])\n")


def ab_frames(trees=("tmp/parent", ".", ".", "tmp/parent")) -> None:
    """The frame A/B of two trees in the order given (parent, change,
    change, parent): `AB_TREE` in each, one process a tree started from it,
    each building its own kernels.  Run by hand, not by main():

        mkdir -p tmp/parent && git archive HEAD | tar -x -C tmp/parent
        python3 -c 'import chip_smoke; chip_smoke.ab_frames()'

    (tmp/ is listed in .gitignore)."""
    for tree in trees:
        log(f"=== tree {tree}")
        subprocess.run([sys.executable, "-c", AB_TREE], cwd=tree, check=True, timeout=900)


# One tree's part of the K7 A/B: chip_smoke.py of the tree that holds
# `ab_k7`, loaded by path, over the package of the tree it runs in.
AB_K7_TREE = ("import importlib.util, json\n"
              "spec = importlib.util.spec_from_file_location('smoke', {path!r})\n"
              "c = importlib.util.module_from_spec(spec)\n"
              "spec.loader.exec_module(c)\n"
              "c.phase_device()\n"
              "c.phase_build()\n"
              "table, config, cam, target, _ = c.make_scene('garden30k_1080p')\n"
              "table = table.to('cuda')\n"
              "mult, _ = c.calibrate(table, cam, config, target)\n"
              "table = c.scaled(table, mult)\n"
              "print(json.dumps({{'tree': {tree!r}, 'k7': c.k7_poses(table, config, cam)}}),"
              " flush=True)\n")


def ab_k7(trees=("tmp/parent", ".", ".", "tmp/parent")) -> None:
    """K7 alone at garden's first pose and at a pose that sees every
    gaussian (`k7_poses`), in the trees given (parent, change, change,
    parent): one process a tree started from it, each building its own
    kernels and printing one JSON line.  Run by hand, not by main():

        mkdir -p tmp/parent && git archive HEAD | tar -x -C tmp/parent
        python3 -c 'import chip_smoke; chip_smoke.ab_k7()'
    """
    path = os.path.abspath(__file__)
    for tree in trees:
        log(f"=== tree {tree}")
        subprocess.run([sys.executable, "-c", AB_K7_TREE.format(path=path, tree=tree)],
                       cwd=tree, check=True, timeout=900)


# Garden's native capture size (Mip-NeRF 360, 5187 x 3361): a 325 x 211
# tile grid whose rows' word holds h in 6 bits (radix_kernel.rows_wide).
NATIVE_SCENE = "garden30k_1080p"
NATIVE_SIZE = (5187, 3361)
NATIVE_FRAMES = 10


def run_native(mult: float):
    """garden's stand-in cloud, at the scale calibrated at 1080p, drawn at
    its native 5187 x 3361 size: its launches a frame (K7, one depth order
    counted as "depth_order_wide", K1, the tile key's setup, histogram and 3
    scatters, K2); the last frame's own radix sort, depth order, K1 and K2
    against their plain versions (`check_radix`, `check_depth_order`,
    `check_kernels`); the rows marked in the word (h above the field, or
    straddling E); the same rows with every kept count read from the scan
    (a grid height that leaves the word one bit for h: the other design of
    the wide record), equal and timed; ms a frame, by pass, on the
    depth-first way and on the index order with the full key, and the two
    images equal.  Returns (results by kernel, launches a frame, the
    path's launches)."""
    table, config, cam, _target, _frames = make_scene(NATIVE_SCENE)
    native = dataclasses.replace(config, width=NATIVE_SIZE[0], height=NATIVE_SIZE[1])
    gw, gh = native.grid_width, native.grid_height
    if not (sort.depth_first(native) and radix_kernel.rows_wide(gw, gh)):
        raise RuntimeError(f"native: a {gw} x {gh} grid must take the wide record")
    renderer = Renderer(native, device="cuda")
    renderer.init_for_scene(scaled(table, mult))
    del table
    cam = first_pose(native)
    base = cam.position.copy()
    reset_counts()
    with Capture() as cap:
        out, frame_ms, passes = timed_draws(renderer, cam, base, NATIVE_FRAMES, cap)
    drawn = WARMUP_FRAMES + NATIVE_FRAMES
    counts = read_counts()
    path = {k: counts[k] for k in UNCAPPED_PATH + ("depth_order_wide",)}
    plan = call_plan(cap.args["radix_sort"])
    kernels = check_radix_kernels("native", plan, counts["radix_sort"],
                                  read_kernels()["radix_sort"], counts["depth_order"])
    tile_passes = len(radix_kernel.schedule(native.num_tiles, "tile"))
    if any(v != drawn for v in path.values()) or plan[2] != "tile" or tile_passes != 3:
        raise RuntimeError(f"native: K7, the depth order (wide), K1, the two-column radix sort "
                           f"and K2 must launch once a frame, {drawn} frames, the sort on the "
                           f"tile key in 3 passes: {path}, plan {plan}, {tile_passes} passes")
    check_image(out.image, native, "native")
    res = check_kernels(cap.args, native, "native", passes)
    res["radix_sort"] = check_radix(cap.args["radix_sort"], "native")
    res["radix_sort"]["kernels_per_sort"] = kernels
    res["depth_order"] = order = check_depth_order(cap.args["depth_order"], "native")
    (cols, cum, capacity, _gw, _gh), _kw = cap.args["depth_order"]
    del cap
    bits = radix_kernel.h_bits(gw, gh)
    kept, word = radix_kernel.pack_rows_plain(cols, cum, capacity, gw, gh)
    order["marked_rows"] = int(((kept > 0) & (word >> (32 - bits) == (1 << bits) - 1)).sum())
    del kept, word
    tall_h = (1 << (31 - 2 * gw.bit_length())) - 1

    def every():
        return radix_kernel.depth_order(cols, cum, capacity, gw, tall_h)

    got, alt = radix_kernel.depth_order(cols, cum, capacity, gw, gh), every()
    m = order["kept_rows"]
    if not (torch.equal(got[1], alt[1]) and torch.equal(got[0][:, :m], alt[0][:, :m])):
        raise RuntimeError("native: every count from the scan differs from the wide record")
    del got, alt
    order["every_from_scan_ms"] = cuda_ms(every, 20)
    order["every_from_scan_device_ms"] = device_kinds(every, {"prep": r"rows_prep",
                                                              "scatter": r"radix_scatter",
                                                              "scan": r"rows_scan"})
    frame = {"live": int(out.num_elements), "frame_ms": statistics.median(frame_ms),
             "passes": passes}
    real = sort.depth_first
    sort.depth_first = lambda config: False
    try:
        index_img, frame_ms, frame["index_order_passes"] = timed_draws(renderer, cam, base,
                                                                      NATIVE_FRAMES)
    finally:
        sort.depth_first = real
    frame["index_order_frame_ms"] = statistics.median(frame_ms)
    if not torch.equal(out.image_u8, index_img.image_u8):
        raise RuntimeError("native: the depth-first image differs from the index order's")
    frame["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["frame"] = frame
    log(f"native {gw} x {gh}: launches {path} over {drawn} frames, {kernels:g} kernels a radix "
        f"sort; {frame['live']} live; {order['marked_rows']} of {m} kept rows marked in the "
        f"word's {bits}-bit h field; the wide record {order['ms']:.3f} ms "
        f"{order['device_ms']}, every count from the scan {order['every_from_scan_ms']:.3f} ms "
        f"{order['every_from_scan_device_ms']}; frame ms depth-first {frame['frame_ms']:.3f} "
        f"{passes}, index order {frame['index_order_frame_ms']:.3f} "
        f"{frame['index_order_passes']}; images equal; peak {frame['peak_bytes']}")
    print(json.dumps({"native": res}), flush=True)
    return res, {k: v / drawn for k, v in counts.items()}, path


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
    planned_global = [len(st) for kind, st in bitonic_kernel.schedule(e) if kind == "global"]
    base = cam.position.copy()
    reset_counts()
    with Capture() as cap:
        out, frame_ms, passes = timed_draws(renderer, cam, base, BITONIC_FRAMES, cap)
    drawn = WARMUP_FRAMES + BITONIC_FRAMES
    launches = read_counts()
    kernels = read_kernels()
    path = {k: launches[k] for k in BITONIC_PATH}
    global_passes = ((LAUNCHES["bitonic_register"] + LAUNCHES["bitonic_wide"]) / drawn,
                     LAUNCHES["bitonic_global_stages"] / drawn)
    if (any(v != drawn for v in path.values()) or kernels["bitonic_sort"] != drawn * planned
            or global_passes != (len(planned_global), sum(planned_global))
            or launches["radix_sort"] or launches["depth_order"] or kernels["radix_sort"]):
        raise RuntimeError(f"{name} bitonic: {drawn} frames launched {path}, kernels {kernels} "
                           f"({planned} a bitonic sort planned), global passes and stages a sort "
                           f"{global_passes} (planned {planned_global}), radix_sort "
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
            "fused global passes": r"bitonic_(global|wide)_kernel",
            "first sort": r"bitonic_shared_kernel<true",
            "merges": r"bitonic_shared_kernel<false, false>",
            "last merge": r"bitonic_shared_kernel<false, true>",
        }),
        "kernels_per_sort": planned,
        "global_passes_per_sort": global_passes[0],
        "global_stages_per_sort": global_passes[1],
        # Each pass alone (CUDA events): ms a pass by kind and distances.
        "pass_ms": pass_kinds(bitonic_pass_ms(el, bitonic_kernel.launches(e))),
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
        f"{res['device_ms']}; {global_passes[0]:g} global passes a sort running "
        f"{global_passes[1]:g} stages; each pass alone, ms a pass (passes a sort) "
        f"{res['pass_ms']}; ptxas {' | '.join(ptxas)}")
    return res, launches, {k: v / drawn for k, v in launches.items()}


def bitonic_pass_ms(el, passes, iters: int = 20) -> list:
    """Each pass of `passes` (bitonic_kernel.Launch) alone on `el`'s slots,
    after a sort through them: [(pass, device ms)], the mean of `iters`
    launches in place between two CUDA events.  A pass's work does not
    depend on its data (selects, no branches), so repeating it in place
    times it."""
    lib = _build.load_library()
    e = el.tile.shape[0]
    cols = [x.contiguous() for x in el[:3]]
    out = [torch.empty_like(x) for x in cols]
    keys = torch.empty(e, dtype=torch.int64, device="cuda")
    idx = torch.empty(e, dtype=torch.int32, device="cuda")
    args = (*(x.data_ptr() for x in cols), e, keys.data_ptr(), idx.data_ptr(),
            *(x.data_ptr() for x in out))
    stream = torch.cuda.current_stream().cuda_stream

    def run(p):
        err = lib.vk3d_bitonic_pass(bitonic_kernel.KINDS[p.kind], *args, p.k, p.lo_bit, p.group,
                                    el.tile.device.index, stream)
        if err:
            raise _build.cuda_error(err, f"bitonic ({p.kind} pass, k {p.k}, group {p.group})")

    for p in passes:
        run(p)
    times = []
    for p in passes:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run(p)
        end.record()
        end.synchronize()
        times.append((p, start.elapsed_time(end) / iters))
    return times


def pass_kinds(times) -> dict:
    """`bitonic_pass_ms`'s times by kind: the first sort, the merges and
    the global passes by their kernel and number of distances, each {ms:
    mean ms a pass, passes: a sort}, and the sort's sum."""
    kinds = {}
    for p, ms in times:
        glob = bitonic_kernel.SECTIONS[p.kind] == "bitonic_global"
        kinds.setdefault(f"{p.kind} g={p.group}" if glob else p.kind, []).append(ms)
    out = {k: {"ms": round(statistics.mean(v), 4), "passes": len(v)} for k, v in kinds.items()}
    out["sum_ms"] = round(sum(ms for _p, ms in times), 4)
    return out


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
        keygen_pass = check_keygen_pass(device_ops(draw, K7_KERNEL), f"{name} capped",
                                        depth_order=True)
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
                        launches["radix_sort"], read_kernels()["radix_sort"],
                        launches["depth_order"])
    if launches["radix_two_column"]:
        raise RuntimeError(f"{name} capped: {launches['radix_two_column']} sorts left out the "
                           "depth the capped blend reads")
    tables = cap.counts.get("pack_feature_table", 0)
    if tables:
        raise RuntimeError(f"{name} capped: the capped frames built {tables} feature tables")
    path_kernels = ["keygen_project", "depth_order", "expand_rows", "radix_sort", "blend_flat",
                    "compact_slabs"]
    if chained:
        path_kernels += ["expand_rows_streamed", "keygen_count"]
    if (min(launches[k] for k in path_kernels) == 0 or per_frame["radix_sort"] != 1
            or per_frame["depth_order"] != 1):
        raise RuntimeError(f"{name} capped: a kernel of the path was not launched, or the radix "
                           f"sort and the depth order not once a timed frame: {launches}, per "
                           f"timed frame {per_frame}")
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
        f"frame {syncs / SYNC_FRAMES:g} {sync_lines}; a keygen pass's device ops {keygen_pass}; "
        f"launches {launches}; per timed frame {per_frame}")
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
        torch.stack([sbase // align, counts, off]).to(torch.int32),
        torch.cumsum(slabw // align, 0, dtype=torch.int64), nchunks)
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
    table = blend_ops.pack_feature_table(frame)
    img, t_k = blend_ops.blend_flat(frame, lay.gid, pranges, config, with_t=True)
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
        "ms": cuda_ms(lambda: blend_ops.blend_flat(frame, lay.gid, pranges, config,
                                                      with_t=True), 20),
        "plain_ms": cuda_ms(lambda: blend_ops.blend_flat_plain(
            blend_ops.pack_feature_table(frame), lay.gid, pranges, config, with_t=True), 1),
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
    check_launches = LAUNCHES["compact_segments"]
    got6 = compact_kernel.compact_segments(src, src0, ep5)
    check_launches = LAUNCHES["compact_segments"] - check_launches
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

    # K7 on the prefiltered frame's own call (the live thresholds).
    keygen_call = [c for c in cap.calls["project_gaussians"] if c[0][5] is not None][-1]
    if keygen_call[0][6] is not None:
        res["capped_keygen"] = check_keygen({"project_gaussians": keygen_call},
                                            f"{name} capped")

    # The radix sort on the last frame's list.
    res["capped_radix"] = check_radix(cap.args["radix_sort"], f"{name} capped")

    # K1' under the prefilter.
    streamed = [c for c in cap.calls.get("expand_elements", []) if c[1].get("streamed")]
    if streamed:
        res["expand_rows_streamed"] = check_expansion(streamed[-1], f"{name} capped")

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
        + "".join(f"; {k} (expand_elements) == plain bit for bit ({res[k]['live']} live of "
                  f"{res[k]['capacity']}), {res[k]['ms']:.3f} ms vs plain "
                  f"{res[k]['plain_ms']:.3f}, kernels {res[k]['device_ms']}, bound "
                  f"{res[k]['bound_ms']:.4f} ({res[k]['bound_by']})"
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
    # The received lists keep the index order and the full key: no depth order.
    radix_kernels = check_radix_kernels(f"rank {rank}", call_plan(cap.args["radix_sort"]),
                                        launches["radix_sort"], read_kernels()["radix_sort"],
                                        launches["depth_order"])
    if launches["depth_order"] or launches["radix_two_column"]:
        raise RuntimeError(f"rank {rank}: the distributed frame put its rows in depth order or "
                           "sorted without the depth")
    # One more frame at the last camera on every rank, under the profiler.
    keygen_pass = check_keygen_pass(
        device_ops(lambda: frame(shard, view, proj, cam.position)), f"rank {rank}")
    passes = {k: v / timed for k, v in timer.totals().items()}

    # K4 on each phase's own inputs (launches here are not the path's).
    phases = cap.calls["blend_strip"]
    if len(phases) != world:
        raise RuntimeError(f"rank {rank}: {len(phases)} blend_strip calls in a frame, not {world}")
    err = 0.0
    stopped_early = 0
    for s, (a, k) in enumerate(phases):
        got = blend_ops.blend_strip(*a, **k)
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
            cuda_ms(lambda: blend_ops.blend_strip(*a, **k), 20) for a, k in phases)
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
        "keygen_pass": keygen_pass,
        "plan": tuple(plan),
        "elements": [int((a[2][:, 1] - a[2][:, 0]).clamp(min=0).sum()) for a, _k in phases],
    }, f"{outdir}/rank{rank}.pt")


# The kernels every rank of the distributed frame launches.
DIST_KERNELS = ("keygen_project", "expand_rows", "radix_sort", "blend_strip")


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
            + f"; [live, sent, recv, dropped] per rank {stats.tolist()}; rank 0's keygen pass "
            f"{ranks[0]['keygen_pass']} (checked on every rank); strip slots per phase "
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
            rcs = []
            cli_ops = device_ops(lambda: rcs.append(cli.main([
                "--ply", path, "--width", str(width), "--height", str(height),
                "--frames", str(APP_FRAMES), "--out", png])))
            rc = rcs[0]
            cli_s = time.perf_counter() - t0
            keygen_pass = check_keygen_pass(cli_ops, "app CLI", depth_order=True)
            launches = read_counts()
            if rc != 0 or any(launches[k] != APP_FRAMES for k in UNCAPPED_PATH):
                raise RuntimeError(f"app: the CLI returned {rc}, launches {launches}")
            # The CLI's uncapped frame sorts the count's prefix on the tile key.
            check_radix_kernels("app", (RenderConfig(width=width, height=height).num_tiles, True,
                                        "tile"),
                                launches["radix_sort"], read_kernels()["radix_sort"],
                                launches["depth_order"])
            got = image_io.read_png(png)

            # The CLI again with the bitonic tier: the same PNG.
            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(["--ply", path, "--width", str(width), "--height", str(height),
                           "--frames", str(APP_FRAMES), "--sort", "bitonic", "--out", png])
            torch.cuda.synchronize()
            bitonic_s = time.perf_counter() - t0
            bitonic_launches = read_counts()
            planned = bitonic_kernel.planned_passes(RenderConfig(width=width, height=height)
                                                    .sort_capacity(n))
            if rc != 0 or any(bitonic_launches[k] != APP_FRAMES for k in BITONIC_PATH) or (
                    read_kernels()["bitonic_sort"] != APP_FRAMES * planned
                    or bitonic_launches["radix_sort"]):
                raise RuntimeError(f"app: the bitonic CLI returned {rc}, launches "
                                   f"{bitonic_launches}, {read_kernels()['bitonic_sort']} kernels")
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
        f"{APP_FRAMES} frames in {cli_s:.2f} s with the load and the profiler, launches "
        f"{launches}, a keygen pass's device ops {keygen_pass}; its PNG == "
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
    # keygen's expansion with the slot decode (JAX ops/keygen.py:203-262) in
    # its store.
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
    # Also the distributed frame's 3-key sort, parallel/dist.py:195 _sort3.
    "radix_sort": ("vk3dgaussiansplatting_tpu_torch/csrc/radix.cu",
                   "vk3dgaussiansplatting_tpu/ops/sort.py:37"),
    # The frame's sort's depth key, settled per gaussian before the
    # expansion (the radix path's keygen).
    "depth_order": ("vk3dgaussiansplatting_tpu_torch/csrc/radix.cu",
                    "vk3dgaussiansplatting_tpu/ops/sort.py:37"),
}
NOT_TPU_KERNELS = ("bitonic_sort", "keygen_project", "radix_sort", "depth_order")


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
        if name == "garden30k_1080p":  # the SH gate at its first pose and with nothing culled
            poses = k7_poses(renderer.table, renderer.config, first_pose(renderer.config))
            results[name]["keygen_project"]["poses"] = poses
            log(f"check {name} keygen: K7 at two poses (SH rows read, share of N, K7 alone ms, "
                f"wrapper ms): {poses}")
        results[name]["radix_sort"] = check_radix(args["radix_sort"], name)
        results[name]["radix_three_column"] = check_radix_three_column(
            args, name, results[name]["radix_sort"])
        results[name]["depth_order"] = check_depth_order(args["depth_order"], name)
        # The kernels a sort that the uncapped frames launched.
        results[name]["radix_sort"]["kernels_per_sort"] = radix_kernels
        for k, v in scene_launches.items():
            launches[k] += v
        del renderer, args
        torch.cuda.empty_cache()
    # garden at its native size: the depth order's wide record, the 17-bit
    # tile key, K1 and K2 at 68,575 tiles (kept out of the kernel table,
    # which stays on the scenes' inputs).
    _native, per_frame["native"], path_launches = run_native(mults[NATIVE_SCENE])
    for k, v in path_launches.items():
        launches[k] += v
    del _native
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
                  "radix_sort", "depth_order", "blend_flat", "compact_slabs"):
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
        if k == "keygen_project":  # its counts mode (count_live_elements), its host time
            entry.update(count_launches=launches["keygen_count"], count_ms=res["count_ms"],
                         host_us=res["host_us"], sh_rows_read=res["sh_rows_read"],
                         poses=res.get("poses"))
        if k == "radix_sort":
            entry.update(kernels_per_sort=res["kernels_per_sort"], device_ms=res["device_ms"],
                         copy_ms=res["copy_ms"], scatter_pass_ms=res["scatter_pass_ms"])
        if k == "depth_order":
            entry.update(device_ms=res["device_ms"], kept_rows=res["kept_rows"],
                         passes_floor_ms=res["passes_floor_ms"])
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
