"""Builds and loads the port's CUDA kernels.

Each `csrc/*.cu` file compiles with its own `nvcc` process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds).  The library lands in the package's `_build/` directory under a
name keyed by a hash of the sources, the headers they include and the
flags, so an edited source or header rebuilds and an unchanged tree loads
the existing file.  Nothing here runs at import: the first kernel launch
calls `load_library()`.  A missing `nvcc` or a failed compile raises;
there is no fallback.  ptxas's resource report
(-Xptxas=-v) is kept beside the library as `<library>.log`.

It is also the one seam between the ops and their kernels.  `on_card`
makes the CPU-or-card choice: an entry point with a plain twin calls it at
its top and runs the kernel for CUDA tensors, the twin for CPU tensors, and
raises for any other device; a wrapper that only launches takes its device
from `card_device`.  `launch` is the only code that calls a launching C
entry point: it appends the device index and the device's current stream,
raises on the CUDA error the entry point returns, and counts the launch in
`LAUNCHES`, one `collections.Counter` keyed by kernel:

  expand_rows, expand_rows_streamed     K1, K1' (one kernel, two callers;
                                        keygen's decode variant included)
  keygen_project, keygen_count          K7, full and counts mode
  blend_tiles, blend_flat, blend_strip  K2, K3, K4
  compact_slabs, compact_runs           K5
  compact_segments                      K6
  radix_sort                            radix sorts (one entry-point call each)
  radix_two_column                      those of them that carried no depth
                                        column (the uncapped radix frame's)
  depth_order                           keygen's rows put in depth order (one
                                        call a frame on the radix path)
  depth_order_wide                      those of them on a grid whose record
                                        word holds h narrower than the
                                        grid's height (radix_kernel.rows_wide:
                                        past 4K UHD's 240 x 135 tiles)
  radix_kernels                         the kernels those sorts and depth
                                        orders ran, as the entry points
                                        report them
  bitonic_first, bitonic_merge          the bitonic tier's shared-memory
                                        passes (one first pass a sort)
  bitonic_register, bitonic_wide        its global passes
  bitonic_global_stages                 the stages its global passes ran

"radix_kernels", "radix_two_column", "depth_order_wide" and
"bitonic_global_stages" count no launch of their own: the sorts' wrappers
add them after `launch`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# Where the CUDA toolkit installs by default; CUDA_HOME and PATH come first.
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
# C entry points: name -> (argtypes, restype).  The launchers return the
# cudaError_t of their launch; each takes the device index and the stream.
SIGNATURES = {
    # cols, ncols, cum, n, capacity, part, nblocks, out, device, stream
    "vk3d_expand_rows": ([_P, _I32, _P, _I64, _I64, _P, _I64, _P, _I32, _P], ctypes.c_int),
    # cols, cum, n, capacity, grid_w, part, nblocks, tile, depth, index,
    # count, device, stream
    "vk3d_expand_elements": (
        [_P, _P, _I64, _I64, _I64, _P, _I64, _P, _P, _P, _P, _I32, _P], ctypes.c_int,
    ),
    # screen_pos, cov_inv, color_alpha, index, ranges, num_tiles, grid_w,
    # width, height, alpha_cutoff, transmittance_stop, out, device, stream
    "vk3d_blend_tiles": (
        [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _F32, _F32, _P, _I32, _P],
        ctypes.c_int,
    ),
    # screen_pos, cov_inv, color_alpha, index, num_index, ranges, num_tiles,
    # cap, batch_k, grid_w, width, height, alpha_cutoff, transmittance_stop,
    # out, t_out (or NULL), device, stream
    "vk3d_blend_flat": (
        [_P, _P, _P, _P, _I64, _P, _I32, _I64, _I32, _I32, _I32, _I32, _F32, _F32, _P, _P, _I32,
         _P],
        ctypes.c_int,
    ),
    # rows, index, num_slots, gather, ranges, num_tiles, tile_base, grid_w,
    # alpha_cutoff, transmittance_stop, carry_color, carry_logt, out_color,
    # out_logt, device, stream
    "vk3d_blend_strip": (
        [_P, _P, _I64, _I32, _P, _I32, _I32, _I32, _F32, _F32, _P, _P, _P, _P, _I32, _P],
        ctypes.c_int,
    ),
    # src, e, starts, starts_stride, sbases, slabw, offs, counts, nt, ep, out,
    # device, stream
    "vk3d_compact_slabs": (
        [_P, _I64, _P, _I64, _P, _P, _P, _P, _I64, _I64, _P, _I32, _P], ctypes.c_int,
    ),
    # src, e, astarts, sbases, nt, ep, wmax, out, device, stream
    "vk3d_compact_runs": ([_P, _I64, _P, _P, _I64, _I64, _I64, _P, _I32, _P], ctypes.c_int),
    # src, e, src0, ep, out, device, stream
    "vk3d_compact_segments": ([_P, _I64, _P, _I64, _P, _I32, _P], ctypes.c_int),
    # kind, tile, depth, index, e, keys, idx, out_tile, out_depth, out_index,
    # k, lo_bit, group, device, stream: one pass of the bitonic sort
    "vk3d_bitonic_pass": (
        [_I32, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P], ctypes.c_int,
    ),
    # tile, depth, index, count (or NULL), e, num_tiles, key, scratch,
    # out_tile, out_depth, out_index, out_perm (or NULL), launches (out),
    # device, stream
    "vk3d_radix_sort": (
        [_P, _P, _P, _P, _I64, _I64, _I32, _P, _P, _P, _P, _P, ctypes.POINTER(_I64), _I32, _P],
        ctypes.c_int,
    ),
    # cols, cum, n, capacity, grid_w, grid_h, scratch, out_cols, out_cum,
    # launches (out), device, stream
    "vk3d_radix_depth_order": (
        [_P, _P, _I64, _I64, _I64, _I64, _P, _P, _P, ctypes.POINTER(_I64), _I32, _P],
        ctypes.c_int,
    ),
    # out (host int32), n: csrc/radix.cu's constants
    "vk3d_radix_config": ([_P, _I32], ctypes.c_int),
    # device: the radix scatter's persistent grid, or minus the CUDA error
    "vk3d_radix_resident_blocks": ([_I32], _I64),
    # n, tiles: the int64 words of K7's scratch, or -1 (the launch's refusal)
    "vk3d_keygen_scratch_words": ([_I64, _I64], _I64),
    # position, scale, rot, opacity, sh, n, params (host), thr, total,
    # extents, flags, cols (NULL: counts mode), capacity, cum, color_alpha,
    # cov2d, cov_inv, screen_pos, scratch, scratch_words, device, stream
    "vk3d_keygen_project": ([_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _I64, _P, _P,
                             _P, _P, _P, _P, _I64, _I32, _P], ctypes.c_int),
    "vk3d_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_lib = None
LAUNCHES: collections.Counter = collections.Counter()


def find_nvcc() -> str | None:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def _sources(stems: tuple[str, ...] = ()) -> list[Path]:
    """csrc/*.cu, or only the named ones."""
    return sorted(p for p in CSRC_DIR.glob("*.cu") if not stems or p.stem in stems)


def library_path(extra_flags: tuple[str, ...] = (), stems: tuple[str, ...] = ()) -> Path:
    """The library's path, keyed by the flags, the sources and the headers
    they include (csrc/*.cuh)."""
    digest = hashlib.sha256(" ".join([*NVCC_FLAGS, *extra_flags]).encode())
    for src in _sources(stems) + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvk3d_kernels_{digest.hexdigest()[:16]}.so"


def build(extra_flags: tuple[str, ...] = (), stems: tuple[str, ...] = ()) -> Path:
    """Compile the kernels if their library is not built yet; return it.
    `extra_flags` (e.g. a -D switch) and `stems` (only those csrc/*.cu)
    build a separate library beside the one `load_library` loads."""
    out = library_path(extra_flags, stems)
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
            f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources(stems):
            cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(work / f"{src.stem}.o"),
                   str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
        # Wait for every compile before reporting any failure.
        results = [(cmd, proc, *proc.communicate()) for cmd, proc in procs]
        reports = []
        for cmd, proc, stdout, stderr in results:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}"
                )
            reports.append(stdout + stderr)
        tmp = work / out.name
        objs = [str(work / f"{src.stem}.o") for src in _sources(stems)]
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # ptxas's per-kernel register / shared-memory / spill report.
    out.with_suffix(".log").write_text("".join(reports))
    return out


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel library with typed entry points."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def cuda_error(err: int, name: str) -> RuntimeError:
    """The error for CUDA error `err`, which the C entry point of `name`
    reported."""
    msg = load_library().vk3d_error_string(err).decode()
    return RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def launch(name: str, entry: str, *args, device: torch.device) -> None:
    """Call the C entry point `entry` with `args`, `device`'s index and its
    current stream; raise if it reports a CUDA error, else count one launch
    of `name`."""
    err = getattr(load_library(), entry)(
        *args, device.index, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise cuda_error(err, name)
    LAUNCHES[name] += 1


def on_card(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain twin).  None entries are skipped; raises for any other device
    or for tensors on more than one device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"the tensors must be on one device, got {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def card_device(*tensors) -> torch.device:
    """The one CUDA device of `tensors` (None entries skipped): what a
    wrapper that only launches takes.  Raises otherwise."""
    if not on_card(*tensors):
        raise ValueError("unsupported device cpu: the kernel takes CUDA tensors")
    return tensors[0].device
