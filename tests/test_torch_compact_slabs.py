"""K5 `compact_slabs`, the capped layout's id copy (csrc/compact.cu).

On the CPU the wrapper runs its plain version (`compact_runs_plain` and the
layout's chunk-map mask); it is held on every lane against the JAX
package's Pallas `compact_runs` (interpret mode) masked to each tile's live
window [sbase + off, sbase + off + count) with SENTINEL elsewhere, and the
live lanes against the source runs themselves.  Cases: a layout that
overflows ep, all-empty tiles, tiles at count = cap_max, and the patch
pass's shape (16 slabs of up to PATCH_WMAX, padding entries after the real
tiles).  On the card (`cuda` marker): the kernel bit for bit with its plain
version on the same cases and on a misaligned source view, the unmasked
`compact_runs` on every lane, and the native .ply loader.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu.ops.pallas import compact_kernel as jck
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import capped as tcap
from vk3dgaussiansplatting_tpu_torch.ops.cuda import compact_kernel as tck

torch.set_num_threads(1)
CHUNK = 128
CAP_MAX = 4096
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "gs_export_384.ply"
CASES = ("overflow", "all_empty", "cap_max", "patch")


def _case(name):
    """(src [E] uint32, starts [T], counts [T], ep) of a named layout."""
    rng = np.random.default_rng(CASES.index(name) + 21)
    src = rng.integers(0, 2**32 - 1, 40_000, dtype=np.uint64).astype(np.uint32)
    src[-300:] = SENTINEL  # dead slots inside some live windows
    if name == "overflow":
        counts = rng.integers(0, 700, 45)
        counts[rng.random(45) < 0.2] = 0
        starts = rng.integers(0, src.size - 700, 45)
        starts[-1] = src.size - 200  # reads into the SENTINEL tail
        counts[-1] = 200
        ep = 12_800  # the slabs need more
    elif name == "all_empty":
        starts, counts, ep = rng.integers(0, src.size, 30), np.zeros(30, np.int64), 6_144
    elif name == "cap_max":
        starts = np.array([0, 127, 5_000, 9_999, src.size - CAP_MAX])
        counts = np.full(5, CAP_MAX)
        ep = 5 * (CAP_MAX + 2 * CHUNK)
    else:
        real = rng.integers(0, src.size - tcap.PATCH_WMAX, 5)
        counts = np.zeros(tcap.PATCH_TILES, np.int64)
        counts[:5] = [tcap.PATCH_WMAX - CHUNK, 1, 0, 3_001, 12_345]
        starts = np.zeros(tcap.PATCH_TILES, np.int64)
        starts[:5] = real
        ep = tcap.PATCH_TILES * tcap.PATCH_WMAX
    return src, np.asarray(starts, np.int64), np.asarray(counts, np.int64), ep


def _slabs(starts, counts):
    """The layout's (off, slabw, sbase) of ops/capped.py."""
    off = starts % CHUNK
    slabw = -(-(off + counts) // CHUNK) * CHUNK
    return off, slabw, np.cumsum(slabw) - slabw


def _args(name, device="cpu", src_offset=0):
    src, starts, counts, ep = _case(name)
    off, slabw, sbase = _slabs(starts, counts)
    s = torch.from_numpy(src.astype(np.int64))
    if src_offset:  # a view whose data pointer is 8 bytes off 16-byte alignment
        s = torch.cat([s.new_zeros(src_offset), s]).to(device)[src_offset:]
    t =[torch.from_numpy(x.astype(np.int64)).to(device) for x in (starts, sbase, slabw, off, counts)]
    return (s.to(device), *t, ep)


@pytest.mark.parametrize("case", CASES)
def test_compact_slabs_plain_matches_jax(case):
    src, starts, counts, ep = _case(case)
    off, slabw, sbase = _slabs(starts, counts)
    launches = tck.SLABS_LAUNCHES
    got = tck.compact_slabs(*_args(case)).numpy()
    assert tck.SLABS_LAUNCHES == launches  # CPU tensors: plain version
    assert got.shape == (ep,)

    wmax = max(CHUNK, int(slabw.max()))
    raw = np.asarray(jck.compact_runs(jnp.asarray(src), jnp.asarray(starts.astype(np.int32)),
                                      jnp.asarray(sbase.astype(np.int32)), ep, wmax))
    live = np.zeros(ep, bool)
    for b, o, c in zip(sbase, off, counts):
        live[min(b + o, ep) : min(b + o + c, ep)] = True
    np.testing.assert_array_equal(got, np.where(live, raw.astype(np.int64), SENTINEL))
    for s, b, o, c in zip(starts, sbase, off, counts):
        n = max(0, min(c, ep - b - o))
        np.testing.assert_array_equal(got[b + o : b + o + n], src[s : s + n].astype(np.int64))
    assert (case == "overflow") == (int(sbase[-1] + slabw[-1]) > ep)
    assert live.any() == (case != "all_empty")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: compact_slabs and compact_runs are CUDA kernels")


@pytest.mark.cuda
def test_compact_slabs_kernel_on_cuda():
    _needs_card()
    for case in CASES:
        for src_offset in (0, 1):
            args = _args(case, "cuda", src_offset)
            launches = tck.SLABS_LAUNCHES
            got = tck.compact_slabs(*args)
            assert tck.SLABS_LAUNCHES == launches + 1
            want = tck.compact_slabs_plain(*args)
            assert torch.equal(got, want), f"{case}, source offset {src_offset}"


@pytest.mark.cuda
def test_compact_runs_kernel_every_lane_on_cuda():
    _needs_card()
    for case in CASES:
        src, starts, sbase, slabw, _off, _counts, ep = _args(case, "cuda")
        wmax = max(CHUNK, int(slabw.max()))
        launches = tck.RUNS_LAUNCHES
        got = tck.compact_runs(src, starts, sbase, ep, wmax)
        assert tck.RUNS_LAUNCHES == launches + 1
        assert torch.equal(got, tck.compact_runs_plain(src, starts, sbase, ep, wmax)), case


@pytest.mark.cuda
def test_native_loader_on_cuda_machine():
    """The port's native .ply parser (built with the machine's g++) against
    its numpy parser, and the loaded table on the card."""
    _needs_card()
    from vk3dgaussiansplatting_tpu_torch.io import ply as tply
    from vk3dgaussiansplatting_tpu_torch.native import runtime

    native = runtime.try_load_gaussians(FIXTURE)
    assert native is not None
    numpy_cols = tply.gaussian_columns_from_ply(FIXTURE)
    for key, want in numpy_cols.items():
        np.testing.assert_array_equal(native[key], want, err_msg=key)
    table = tply.load_gaussians(FIXTURE).to("cuda")
    assert table.num_gaussians == 384 and table.device.type == "cuda"
