"""PLY point-cloud IO for 3D Gaussian Splatting scenes — port of
`vk3dgaussiansplatting_tpu.io.ply` (numpy, no JAX).

The reference loads its scenes with hapPLY (ResourceManager::loadGaussians,
ResourceManager.cpp:167-300).  This reader parses the header, reads the body
into per-property numpy columns, and `models.gaussians.from_raw_ply_columns`
applies the reference's activation transforms and Morton sort.  It supports
`format ascii 1.0` and `format binary_little_endian 1.0` with scalar
properties only (gaussian clouds have no list properties); the writer
builds fixtures and exports procedural scenes.

`load_gaussians` reads a file with the native C++ parser (native/runtime.py,
built with g++ at first use); the numpy parser runs only where the native
one reports a layout it does not take (ASCII, non-float32 properties, an
element after the vertices).  A failed build or load of the native library
raises.  Each load logs which parser ran (utils/log.py).
"""

from __future__ import annotations

import io
import os
import time
from dataclasses import dataclass

import numpy as np

from ..utils import log

_PLY_DTYPES = {
    "char": np.int8,
    "int8": np.int8,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "short": np.int16,
    "int16": np.int16,
    "ushort": np.uint16,
    "uint16": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
    "uint32": np.uint32,
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
}

# The 59 gaussian property columns, in the reference's order
# (ResourceManager.cpp:176-222).
GAUSSIAN_PROPERTIES = (
    ["x", "y", "z"]
    + [f"scale_{i}" for i in range(3)]
    + [f"rot_{i}" for i in range(4)]
    + ["opacity"]
    + [f"f_dc_{i}" for i in range(3)]
    + [f"f_rest_{i}" for i in range(45)]
)


@dataclass
class PlyElement:
    name: str
    count: int
    properties: list[tuple[str, np.dtype]]
    data: dict[str, np.ndarray]

    def column(self, name: str) -> np.ndarray:
        if name not in self.data:
            raise KeyError(f"ply element '{self.name}' has no property '{name}'")
        return self.data[name]


@dataclass
class PlyData:
    fmt: str
    elements: list[PlyElement]

    def element(self, name: str | None = None) -> PlyElement:
        if name is None:
            return self.elements[0]
        for e in self.elements:
            if e.name == name:
                return e
        raise KeyError(f"no ply element named '{name}'")


def _parse_header(stream: io.BufferedReader):
    magic = stream.readline().strip()
    if magic != b"ply":
        raise ValueError("not a ply file (missing 'ply' magic)")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, np.dtype]]]] = []
    while True:
        line = stream.readline()
        if not line:
            raise ValueError("unexpected EOF in ply header")
        tokens = line.decode("ascii").strip().split()
        if not tokens:
            continue
        if tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
            if fmt not in ("ascii", "binary_little_endian"):
                raise ValueError(f"unsupported ply format: {fmt}")
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                raise ValueError("list properties are not supported")
            if not elements:
                raise ValueError("property before element in ply header")
            dtype = _PLY_DTYPES.get(tokens[1])
            if dtype is None:
                raise ValueError(f"unknown ply type: {tokens[1]}")
            elements[-1][2].append((tokens[2], np.dtype(dtype)))
        elif tokens[0] == "end_header":
            break
        else:
            raise ValueError(f"unknown ply header line: {line!r}")
    if fmt is None:
        raise ValueError("ply header missing 'format' line")
    return fmt, elements


def read_ply(path: str | os.PathLike) -> PlyData:
    """Read a ply file into per-property numpy columns."""
    with open(path, "rb") as f:
        fmt, header_elements = _parse_header(f)
        elements = []
        if fmt == "binary_little_endian":
            for name, count, props in header_elements:
                record = np.dtype([(p, d.newbyteorder("<")) for p, d in props])
                raw = np.fromfile(f, dtype=record, count=count)
                if raw.shape[0] != count:
                    raise ValueError(
                        f"ply element '{name}': expected {count} records, got {raw.shape[0]}"
                    )
                data = {p: np.ascontiguousarray(raw[p]) for p, _ in props}
                elements.append(PlyElement(name, count, props, data))
        else:  # ascii
            text = f.read().decode("ascii").split()
            cursor = 0
            for name, count, props in header_elements:
                ncols = len(props)
                chunk = text[cursor : cursor + count * ncols]
                cursor += count * ncols
                arr = np.array(chunk, dtype=np.float64).reshape(count, ncols)
                data = {p: arr[:, i].astype(d) for i, (p, d) in enumerate(props)}
                elements.append(PlyElement(name, count, props, data))
        return PlyData(fmt, elements)


def write_ply(
    path: str | os.PathLike,
    columns: dict[str, np.ndarray],
    *,
    element_name: str = "vertex",
    binary: bool = True,
) -> None:
    """Write scalar float32 columns as a ply file."""
    names = list(columns.keys())
    count = len(next(iter(columns.values())))
    for n in names:
        if len(columns[n]) != count:
            raise ValueError("all ply columns must have equal length")
    header = ["ply", "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element {element_name} {count}"]
    header += [f"property float {n}" for n in names]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            record = np.dtype([(n, "<f4") for n in names])
            out = np.empty(count, dtype=record)
            for n in names:
                out[n] = np.asarray(columns[n], dtype=np.float32)
            out.tofile(f)
        else:
            mat = np.stack([np.asarray(columns[n], dtype=np.float32) for n in names], axis=1)
            for row in mat:
                f.write((" ".join(repr(float(v)) for v in row) + "\n").encode())


def gaussian_properties(raw: dict) -> dict[str, np.ndarray]:
    """The 59 raw columns (`raw_ply_columns_from_table`'s dict) as .ply
    properties in the reference's order (GAUSSIAN_PROPERTIES)."""
    props = {"x": raw["xyz"][:, 0], "y": raw["xyz"][:, 1], "z": raw["xyz"][:, 2],
             "opacity": raw["opacities"]}
    for key, stem, width in (("scales", "scale", 3), ("rots", "rot", 4), ("f_dc", "f_dc", 3),
                             ("f_rest", "f_rest", 45)):
        props.update({f"{stem}_{i}": raw[key][:, i] for i in range(width)})
    return {n: props[n] for n in GAUSSIAN_PROPERTIES}


def write_gaussian_ply(path: str | os.PathLike, table) -> None:
    """Export a GaussianTable as a capture-format binary .ply, properties in
    the reference's order (x y z, scale_0..2, rot_0..3, opacity, f_dc_0..2,
    f_rest_0..44), so it loads like a trained capture, native parser
    included."""
    from ..models.gaussians import raw_ply_columns_from_table

    write_ply(path, gaussian_properties(raw_ply_columns_from_table(table)), binary=True)


def gaussian_columns_from_ply(path: str | os.PathLike):
    """The 59 gaussian-splatting property columns of a ply file, by the
    numpy parser (ResourceManager.cpp:176-222); f_rest is zero when the
    file has no higher SH bands."""
    element = read_ply(path).element()

    def col(name):
        return element.column(name).astype(np.float32)

    xyz = np.stack([col("x"), col("y"), col("z")], axis=1)
    scales = np.stack([col("scale_0"), col("scale_1"), col("scale_2")], axis=1)
    rots = np.stack([col(f"rot_{i}") for i in range(4)], axis=1)
    opacities = col("opacity")
    f_dc = np.stack([col("f_dc_0"), col("f_dc_1"), col("f_dc_2")], axis=1)
    have_rest = all(any(p == f"f_rest_{i}" for p, _ in element.properties) for i in range(45))
    if have_rest:
        f_rest = np.stack([col(f"f_rest_{i}") for i in range(45)], axis=1)
    else:
        f_rest = np.zeros((element.count, 45), dtype=np.float32)
    return dict(xyz=xyz, scales=scales, rots=rots, opacities=opacities, f_dc=f_dc, f_rest=f_rest)


def read_gaussian_columns(path: str | os.PathLike) -> tuple[dict, str]:
    """(the 59 columns, the parser that read them: "native" or "numpy")."""
    from ..native import runtime

    cols = runtime.try_load_gaussians(path)
    if cols is not None:
        return cols, "native"
    return gaussian_columns_from_ply(path), "numpy"


def load_gaussians(path: str | os.PathLike, *, morton_sort: bool = True):
    """Load a .ply gaussian cloud into a CPU GaussianTable
    (ResourceManager::loadGaussians: parse, activate, Morton-sort).
    `morton_sort=False` keeps the file's order.  Logs the parser that ran
    and the seconds the parse and the transforms (activations, Morton sort)
    took."""
    from ..models.gaussians import from_raw_ply_columns

    t0 = time.perf_counter()
    cols, parser = read_gaussian_columns(path)
    t1 = time.perf_counter()
    table = from_raw_ply_columns(morton_sort=morton_sort, **cols)
    t2 = time.perf_counter()
    log.write(f"load_gaussians {os.fspath(path)}: {table.num_gaussians} gaussians, {parser} "
              f"parser, {t2 - t0:.3f} s (parse {t1 - t0:.3f}, transforms {t2 - t1:.3f})")
    return table
