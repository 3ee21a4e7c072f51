"""Port parity: PLY IO, the native .ply loader and the PNG codec.

The port's `io/ply.py` against the JAX package's on the same files (binary
and ASCII round trips, `load_gaussians` on tests/fixtures/gs_export_384.ply
with and without the Morton sort, `write_gaussian_ply` byte for byte); the
port's native parser (its own copy of gsnative.cpp, built with g++ into the
port's `_build/`) against its numpy parser, and ASCII taking the numpy
parser; the port's zlib/struct PNG codec against PIL both ways.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from vk3dgaussiansplatting_tpu.io import ply as jply
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.io import image as timage
from vk3dgaussiansplatting_tpu_torch.io import ply as tply
from vk3dgaussiansplatting_tpu_torch.native import runtime

torch.set_num_threads(1)
TESTS = Path(__file__).resolve().parent
FIXTURE = TESTS / "fixtures" / "gs_export_384.ply"
FIELDS = ("position", "scale", "rot", "sh", "opacity")


def _assert_tables_equal(t, j):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trip_matches_jax(tmp_path, binary):
    rng = np.random.default_rng(3)
    cols = {n: rng.normal(size=57).astype(np.float32) for n in ("x", "y", "z", "opacity", "w")}
    ours, theirs = tmp_path / "port.ply", tmp_path / "jax.ply"
    tply.write_ply(ours, cols, binary=binary)
    jply.write_ply(theirs, cols, binary=binary)
    assert ours.read_bytes() == theirs.read_bytes()
    got, want = tply.read_ply(ours), jply.read_ply(ours)
    assert got.fmt == want.fmt == ("binary_little_endian" if binary else "ascii")
    assert [p for p, _ in got.element().properties] == list(cols)
    for n, v in cols.items():
        np.testing.assert_array_equal(got.element().column(n), want.element().column(n))
        np.testing.assert_array_equal(got.element("vertex").column(n), v)


@pytest.mark.parametrize("morton_sort", [True, False])
def test_load_gaussians_fixture_matches_jax(morton_sort):
    got = tply.load_gaussians(FIXTURE, morton_sort=morton_sort)
    assert got.num_gaussians == 384
    _assert_tables_equal(got, jply.load_gaussians(FIXTURE, morton_sort=morton_sort))


def test_native_parser_matches_numpy_parser():
    lib_path = runtime.build()
    assert lib_path.parent.name == "_build" and "vk3dgaussiansplatting_tpu_torch" in lib_path.parts
    native = runtime.try_load_gaussians(FIXTURE)
    assert native is not None
    for key, want in tply.gaussian_columns_from_ply(FIXTURE).items():
        np.testing.assert_array_equal(native[key], want, err_msg=key)
    cols, parser = tply.read_gaussian_columns(FIXTURE)
    assert parser == "native"


def test_ascii_ply_takes_the_numpy_parser(tmp_path):
    raw = tply.gaussian_columns_from_ply(FIXTURE)
    path = tmp_path / "ascii.ply"
    tply.write_ply(path, tply.gaussian_properties(raw), binary=False)
    assert runtime.try_load_gaussians(path) is None  # the native parser declines ASCII
    cols, parser = tply.read_gaussian_columns(path)
    assert parser == "numpy"
    for key, want in raw.items():
        np.testing.assert_array_equal(cols[key], want, err_msg=key)
    _assert_tables_equal(tply.load_gaussians(path), jply.load_gaussians(path))


def test_write_gaussian_ply_round_trip(tmp_path):
    jtable = jsyn.procedural_cloud_table(500, seed=9)
    ours, theirs = tmp_path / "port.ply", tmp_path / "jax.ply"
    tply.write_gaussian_ply(ours, convert.table_from_jax(jtable))
    jply.write_gaussian_ply(theirs, jtable)
    assert ours.read_bytes() == theirs.read_bytes()
    back = tply.load_gaussians(ours, morton_sort=False)
    _assert_tables_equal(back, jply.load_gaussians(theirs, morton_sort=False))
    for f in FIELDS:  # the float32 exp/log and sigmoid/logit round trips
        np.testing.assert_allclose(getattr(back, f).numpy(), np.asarray(getattr(jtable, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_png_matches_pil_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    for c in (3, 4):
        noise = rng.integers(0, 256, (37, 53, c), dtype=np.uint8)
        y, x = np.mgrid[0:37, 0:53]
        smooth = np.stack([x * 4, y * 6, x + y, 255 - x][:c], -1).astype(np.uint8)
        for k, img in enumerate((noise, smooth)):
            ours = tmp_path / f"port_{c}_{k}.png"
            timage.write_png(ours, img)
            np.testing.assert_array_equal(np.asarray(Image.open(ours)), img)
            pil = tmp_path / f"pil_{c}_{k}.png"
            Image.fromarray(img).save(pil)  # PIL picks its row filters
            np.testing.assert_array_equal(timage.read_png(pil), img)
    for golden in sorted((TESTS / "golden").glob("*.png")):
        np.testing.assert_array_equal(timage.read_png(golden), np.asarray(Image.open(golden)))
    with pytest.raises(TypeError):
        timage.write_png(tmp_path / "bad.png", np.zeros((2, 2, 3), np.float32))
