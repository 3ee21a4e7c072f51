"""Bridge to the port's native .ply loader (native/gsnative.cpp).

Port of `vk3dgaussiansplatting_tpu.native.runtime`, with the port's own copy
of the C++ source.  The library is built at first use with
`g++ -O3 -std=c++17 -shared -fPIC -pthread` (the g++ on PATH) into the
package's `_build/` directory, under a name keyed by a hash of the
compiler, the source and the flags, and loaded with ctypes.  Unlike the JAX runtime, which returns None when its
library is missing, a missing compiler, a failed build or a failed load
raises: the numpy parser runs only where the native parser itself reports a
layout it does not take (`try_load_gaussians` returns None then).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "gsnative.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None


def _compiler() -> str:
    # The g++ on PATH, not $CXX: the library must link the C++ runtime the
    # process already holds (torch's); a compiler that links its own
    # (statically) gives a library whose first file read crashes.
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no g++ on PATH: the native .ply loader cannot be built")
    return cxx


def library_path(cxx: str) -> Path:
    """The library's path, keyed by the compiler, the flags and the source."""
    digest = hashlib.sha256(" ".join([cxx, *CXX_FLAGS]).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libgsnative_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader if its library is not built yet; return it."""
    cxx = _compiler()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = Path(work) / out.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native loader build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds leave one library
    return out


def get_lib() -> ctypes.CDLL:
    """Build (once) and load the library with typed entry points."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gs_load_ply.restype = ctypes.c_int
        lib.gs_load_ply.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.gs_fetch_columns.restype = ctypes.c_int
        lib.gs_fetch_columns.argtypes = [ctypes.c_void_p] * 6
        lib.gs_free.restype = None
        lib.gs_free.argtypes = []
        _lib = lib
    return _lib


def try_load_gaussians(path) -> dict | None:
    """The 59 columns of a binary .ply by the native parser (the dict of
    io.ply.gaussian_columns_from_ply), or None where the parser reports a
    layout it does not take (ASCII, a non-float32 property, a list
    property, a second element with records) or cannot open the file."""
    lib = get_lib()
    count = ctypes.c_int64(0)
    if lib.gs_load_ply(os.fsencode(os.fspath(path)), ctypes.byref(count)) != 0:
        return None
    n = count.value
    cols = dict(
        xyz=np.empty((n, 3), dtype=np.float32),
        scales=np.empty((n, 3), dtype=np.float32),
        rots=np.empty((n, 4), dtype=np.float32),
        opacities=np.empty((n,), dtype=np.float32),
        f_dc=np.empty((n, 3), dtype=np.float32),
        f_rest=np.empty((n, 45), dtype=np.float32),
    )
    try:
        if n and lib.gs_fetch_columns(*(a.ctypes.data_as(ctypes.c_void_p) for a in cols.values())):
            raise RuntimeError(f"native loader: fetching the columns of {path} failed")
    finally:
        lib.gs_free()
    return cols
