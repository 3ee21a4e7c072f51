"""Builds and loads the port's CUDA kernels.

All `csrc/*.cu` files compile with `nvcc` into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds).  The library lands in the package's `_build/` directory under a
name keyed by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads the existing file.  Nothing here runs at import:
the first kernel launch calls `load_library()`.  A missing `nvcc` or a
failed compile raises; there is no fallback.  ptxas's resource report
(-Xptxas=-v) is kept beside the library as `<library>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# Where the CUDA toolkit installs by default; CUDA_HOME and PATH come first.
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
# C entry points: name -> (argtypes, restype).  The launchers return the
# cudaError_t of their launch; each takes the device index and the stream.
SIGNATURES = {
    # cols, ncols, cum, n, capacity, out, device, stream
    "vk3d_expand_rows": ([_P, _I32, _P, _I64, _I64, _P, _I32, _P], ctypes.c_int),
    # table, index, ranges, num_tiles, grid_w, width, height, alpha_cutoff,
    # transmittance_stop, out, device, stream
    "vk3d_blend_tiles": (
        [_P, _P, _P, _I32, _I32, _I32, _I32, _F32, _F32, _P, _I32, _P],
        ctypes.c_int,
    ),
    "vk3d_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_lib = None


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


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvk3d_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if their library is not built yet; return it."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
            f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(s) for s in _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    # ptxas's per-kernel register / shared-memory / spill report.
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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


def check_launch(err: int, name: str) -> None:
    """Raise if the C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = load_library().vk3d_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
