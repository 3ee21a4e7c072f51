"""keygen's expansion with the decode in its store (`expand_kernel.
expand_elements`, csrc/expand.cu's decode variant): keygen's six int32 rows
expanded over E slots and written as the sort elements (tile, depth, index
and the count) in one launch.

On the CPU its plain version (`decode_slots_plain` over `expand_rows_plain`)
against a numpy model of the per-slot decode (each slot's row by a search
over the scan), on each edge case: E odd and E = 2 mod 4 (the kernel's
scalar stores and its pairs cut at a block's edge), the total below, at and
above E, a zero total, N = 0, E = 0, one gaussian whose run spans several
512-item blocks, and offsets that put a slot's local index outside
[0, 2^32) (the kernel's 64-bit floor division).  On the card (`cuda` marker,
skipped without one) the kernel against the plain version bit for bit on
the same cases, under both launch counts, and on the benchmark's calibrated
garden frame at its two capacities (14,190,624 slots and 2^24).  A file of
its own, without JAX (ROADMAP.md, "Port tests").
"""

import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable
from vk3dgaussiansplatting_tpu_torch.ops.cuda import _build, expand_kernel, keygen_kernel

torch.set_num_threads(1)

GRID_W = 120


def _rows(counts, capacity, seed, *, random_offsets=False):
    """keygen's [6, N] int32 rows for `counts` and their inclusive int64
    scan: ids, the exclusive offsets clamped to `capacity` (or random int32
    values), max(w, 1), min_x, min_y and depth bits."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    n = len(counts)
    cum = np.cumsum(counts)
    offset = np.minimum(cum - counts, capacity)
    if random_offsets:
        offset = rng.integers(-(2**31), 2**31, size=n)
    cols = np.stack([
        np.arange(n),
        offset,
        rng.integers(1, 40, size=n),
        rng.integers(0, GRID_W, size=n),
        rng.integers(0, 70, size=n),
        rng.integers(-(2**31), 2**31, size=n),
    ]).astype(np.int32)
    return torch.from_numpy(cols), torch.from_numpy(cum)


def _cases(name):
    """The (cols, cum, capacity) inputs of edge case `name`."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 9, size=900)
    counts[rng.random(900) < 0.4] = 0
    total = int(counts.sum())
    long_run = np.zeros(700, np.int64)
    long_run[[5, 300, 301]] = [3, 2600, 7]  # row 300 spans several blocks
    if name == "empty":  # a zero total, N = 0, E = 0
        return [(*_rows(np.zeros(500, np.int64), 1030, 4), 1030),
                (*_rows(np.zeros(0, np.int64), 64, 4), 64),
                (*_rows(counts, 0, 4), 0)]
    if name == "random_offsets":
        return [(*_rows(counts, total, 5, random_offsets=True), total + 2)]
    counts, capacity = {
        "e_odd": (counts, (total + 301) | 1),
        "e_2_mod_4": (counts, (total + 300) // 4 * 4 + 2),
        "total_eq_e": (counts, total),
        "total_gt_e": (counts, total - 1001),
        "long_run": (long_run, 2611),
    }[name]
    return [(*_rows(counts, capacity, 4), capacity)]


CASES = ("e_odd", "e_2_mod_4", "total_eq_e", "total_gt_e", "empty", "long_run", "random_offsets")


def _numpy_elements(cols, cum, capacity, grid_w):
    """The sort elements slot by slot: slot j's row r = #{i : cum[i] <= j},
    live below min(total, E), decoded with floor division."""
    cols, cum = cols.numpy().astype(np.int64), cum.numpy()
    total = int(cum[-1]) if len(cum) else 0
    count = min(total, capacity)
    j = np.arange(capacity, dtype=np.int64)
    r = np.minimum(np.searchsorted(cum, j, side="right"), max(len(cum) - 1, 0))
    live = j < count
    if len(cum) == 0:
        return [np.full(capacity, SENTINEL, np.int64)] * 3 + [count]
    local = j - cols[1][r]
    gw = np.maximum(cols[2][r], 1)
    ly = np.floor_divide(local, gw)
    tile = (cols[4][r] + ly) * grid_w + cols[3][r] + (local - ly * gw)
    depth = cols[5][r] & 0xFFFFFFFF
    return [np.where(live, v, SENTINEL) for v in (tile, depth, cols[0][r])] + [count]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_numpy_decode(case):
    for cols, cum, capacity in _cases(case):
        got = expand_kernel.expand_elements(cols, cum, capacity, GRID_W)
        want = _numpy_elements(cols, cum, capacity, GRID_W)
        for name, a, b in zip(("tile", "depth", "index"), got, want):
            assert a.dtype == torch.int64 and a.shape == (capacity,), name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{case}: {name}")
        assert got[3].shape == () and int(got[3]) == want[3]


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: csrc/expand.cu is a CUDA kernel with no CPU mode")


@pytest.mark.cuda
def test_kernel_matches_plain_on_edge_cases_on_cuda():
    """Every edge case on the card, as K1 and as K1', bit for bit with the
    plain version, one launch each, counted under its key."""
    _require_card()
    for case in CASES:
        for cols, cum, capacity in _cases(case):
            cols, cum = cols.cuda(), cum.cuda()
            want = expand_kernel.expand_elements_plain(cols, cum, capacity, GRID_W)
            for streamed, key in ((False, "expand_rows"), (True, "expand_rows_streamed")):
                before = _build.LAUNCHES[key]
                got = expand_kernel.expand_elements(cols, cum, capacity, GRID_W,
                                                    streamed=streamed)
                torch.cuda.synchronize()
                assert _build.LAUNCHES[key] == before + 1, (case, key)
                for name, a, b in zip(("tile", "depth", "index", "count"), got, want):
                    bad = int((a != b).sum())
                    assert torch.equal(a, b), f"{case} E={capacity} {key}: {name}, {bad} slots"


@pytest.mark.cuda
def test_kernel_on_calibrated_garden_frames_on_cuda():
    """The benchmark's garden frame (its scene from a seed, calibrated to
    13.1M live elements) at the radix cell's capacity and at the bitonic
    cell's 2^24: the kernel over K7's rows equals the plain version."""
    _require_card()
    from splatbench import run, spec

    seen = []
    for name in ("garden-orbit", "garden-bitonic-orbit"):
        cell = spec.load_cell(name)
        config = run.render_config(cell)
        cloud, orbit, _fr, _mult, _live = run.make_scene(cell, 1_234_567_891,
                                                         torch.device("cuda"))
        table = GaussianTable(*cloud)
        cam = orbit.centre()
        view, proj = cam.matrices()
        capacity = config.sort_capacity(table.num_gaussians)
        p = keygen_kernel.project_gaussians(table, view, proj, cam.position, config, capacity)
        args = (p.cols, p.cum, capacity, config.grid_width)
        got = expand_kernel.expand_elements(*args)
        want = expand_kernel.expand_elements_plain(*args)
        for col, a, b in zip(("tile", "depth", "index", "count"), got, want):
            assert torch.equal(a, b), f"{name}: {col} differs at {int((a != b).sum())} slots"
        assert 0 < int(got[3]) < capacity
        seen.append(capacity)
        del table, cloud, p, got, want
        torch.cuda.empty_cache()
    assert seen == [14_190_624, 1 << 24]
