"""The benchmark cell `garden-bitonic-orbit`: garden at 1080p on the
reference renderer's bitonic merge sort over its 2^24-slot power-of-two
buffer (splatbench/configs/garden30k_1080p_bitonic.json).

On the CPU: the port's frame at a tiny size with the cell's render settings
against the benchmark's reference under the cell's limits; the cell's files
and its capacity; the wrapper's per-pass launches (`bitonic_kernel.
launches`, what the C entry point `vk3d_bitonic_pass` takes) against the
stages of the network; the roofline reader's compare-exchange count
against the plain network's; the three readers without their sections.
On the card (`cuda` marker): the pass sections a sort records, in both
tracer modes, and the sorted output with and without a timer.
"""

import collections

import pytest
import torch

from splatbench import judge, metrics, reference, run, scene, spec
from splatbench.metrics import bitonic_roofline_pct
from vk3dgaussiansplatting_tpu_torch import Renderer, SortAlgorithm
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable
from vk3dgaussiansplatting_tpu_torch.ops import bitonic as tbit
from vk3dgaussiansplatting_tpu_torch.ops.cuda import bitonic_kernel as tbk
from vk3dgaussiansplatting_tpu_torch.ops.keygen import SortElements
from vk3dgaussiansplatting_tpu_torch.utils.timing import CudaPassTimer

torch.set_num_threads(2)

CELL = "garden-bitonic-orbit"
# The tiny frame: the cell's render settings at 192x96, 4,000 gaussians.
TINY = {"gaussians": 4000, "width": 192, "height": 96, "target_live": 20000}


def _network_stages(e: int) -> list[tuple[int, int]]:
    """Every stage (k, j) of the XOR network over `e` slots, in order."""
    return [(1 << lk, 1 << lj) for lk in range(1, e.bit_length())
            for lj in range(lk - 1, -1, -1)]


def _stages_of(p: tbk.Launch) -> list[tuple[int, int]]:
    """The stages csrc/bitonic.cu's vk3d_bitonic_pass runs for one launch:
    a first pass every k up to its k, a global pass its `group` distances
    from 2^(lo_bit+group-1) down, a merge the distances below BLOCK."""
    if p.kind == "first":
        return _network_stages(p.k)
    if p.kind in ("register", "wide"):
        return [(p.k, 1 << b) for b in range(p.lo_bit + p.group - 1, p.lo_bit - 1, -1)]
    return [(p.k, 1 << b) for b in range(tbk.BLOCK.bit_length() - 2, -1, -1)]


def _random_elements(seed: int, e: int, device: str = "cpu") -> SortElements:
    """A list of `e` slots: live triples with repeated (tile, depth) pairs,
    a SENTINEL tail past the live count."""
    g = torch.Generator().manual_seed(seed)
    live = e - e // 8
    tile = torch.randint(0, 8160, (e,), generator=g, dtype=torch.int64)
    depth = torch.randint(0, 1 << 12, (e,), generator=g, dtype=torch.int64) << 20
    index = torch.randperm(e, generator=g).to(torch.int64)
    for x in (tile, depth, index):
        x[live:] = SENTINEL
    return SortElements(tile.to(device), depth.to(device), index.to(device),
                        count=torch.tensor(live, dtype=torch.int64, device=device))


@pytest.mark.parametrize("seed", [2**31 + 5, 7], ids=["large-seed", "small-seed"])
def test_cpu_frame_is_within_the_cells_limits(seed, monkeypatch):
    """The port's frame with the cell's render settings (bitonic, the
    capacity rounded to a power of two, uncapped) at a tiny size on a
    seeded cloud against the benchmark's reference, under the cell's
    limits; the frame sorts with the bitonic tier."""
    cell = spec.load_cell(CELL)
    render = dict(cell.config["render"], width=TINY["width"], height=TINY["height"])
    cell = cell._replace(config=dict(cell.config, render=render))
    fr = reference.frame_constants(run.render_settings(cell), TINY["gaussians"])
    rc = run.render_config(cell)
    assert rc.sort_algorithm == SortAlgorithm.BITONIC and rc.capacity_pow_two
    assert rc.sort_capacity(TINY["gaussians"]) == fr.capacity == 131072
    sorts = []
    monkeypatch.setattr(tbit, "sort_elements_bitonic_plain",
                        lambda el, _real=tbit.sort_elements_bitonic_plain: sorts.append(1)
                        or _real(el))
    cloud = scene.make_cloud(TINY["gaussians"], cell.config["assumed"]["cloud"], seed, "cpu")
    loop = cell.traffic["camera"]
    orbit = scene.Orbit(cell.config["assumed"]["camera"], rc.width / rc.height, loop["poses"],
                        0.05, seed)
    mult, _ = scene.calibrate(cloud, orbit.centre(), fr, TINY["target_live"], 0.001)
    cloud = scene.scaled(cloud, mult)
    r = Renderer(rc, device="cpu")
    r.init_for_scene(GaussianTable(*cloud))
    readings = []
    for i in range(3):
        cam = orbit.camera(i)
        out = r.draw(cam)
        view, proj = cam.matrices()
        img, _p, s, _rows = reference.render(cloud, view, proj, cam.position, fr)
        assert int(out.num_elements) == s.live
        readings.append(judge.compare(out.image_u8, img))
    correct, checks = judge.judge(readings, cell.limits)
    assert correct, checks
    assert len(sorts) == 3


def test_the_cell_loads_at_the_reference_renderers_capacity():
    """The cell's files load, its render settings are ones the reference
    judges, and the configuration's capacity is ceilPow2(N + 1024 tiles),
    the reference's and the port's alike."""
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.config["name"] == "garden30k_1080p_bitonic"
    settings = run.render_settings(cell)
    n = cell.config["gaussians"]
    rc = run.render_config(cell)
    assert rc.sort_algorithm == SortAlgorithm.BITONIC and rc.blend_depth_cap == 0
    assert (cell.config["capacity"] == reference.frame_constants(settings, n).capacity
            == rc.sort_capacity(n) == 16777216)
    assert [m["name"] for m in cell.end_to_end] == ["frame_ms", "frame_p95_ms", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert {"sort_ms", "sort_roofline_pct", "bitonic_shared_ms", "bitonic_global_ms",
            "bitonic_roofline_pct"} <= names


def test_launches_cover_every_stage_once_in_order():
    """For E = 2 .. 2^16, across BLOCK, and at 2^20 and 2^24, where a k's
    global distances take more than one pass: the launch arguments the
    wrapper derives from `schedule(E)` run every stage (k, j) of the
    network once and in order (a lone block short of BLOCK padded to it),
    and each is a pass the C entry point accepts."""
    for e in [1 << x for x in range(1, 17)] + [1 << 20, 1 << 24]:
        got = [st for p in tbk.launches(e) for st in _stages_of(p)]
        assert got == _network_stages(max(e, tbk.BLOCK)), e
        assert got == [st for _, stages in tbk.schedule(e) for st in stages], e
        for p in tbk.launches(e):
            if p.kind == "first":
                continue
            assert 2 * tbk.BLOCK <= p.k <= e and p.k & (p.k - 1) == 0, (e, p)
            if p.kind in ("register", "wide"):
                assert p.kind == tbk.kernel_kind("global", p.group), (e, p)
                assert 1 <= p.group <= (5 if p.kind == "register" else tbk.GROUP), (e, p)
                assert p.lo_bit >= tbk.BLOCK.bit_length() - 1, (e, p)
                assert p.lo_bit + p.group <= p.k.bit_length() - 1, (e, p)
    sections = collections.Counter(tbk.SECTIONS[p.kind] for p in tbk.launches(1 << 24))
    assert sections == {"bitonic_shared": 12, "bitonic_global": 13}


def test_compare_exchange_count_is_the_plain_networks(monkeypatch):
    """The roofline's compare-exchanges at a power-of-two L = 2 .. 2^12
    equal those the plain network (the JAX stage schedule) makes sorting L
    elements."""
    made = [0]
    real = tbit._compare_exchange

    def counted(lo, hi):
        made[0] += lo[0].numel()
        return real(lo, hi)

    monkeypatch.setattr(tbit, "_compare_exchange", counted)
    for lg in range(1, 13):
        made[0] = 0
        e = 1 << lg
        out = tbit.sort_elements_bitonic_plain(_random_elements(lg, e))
        assert made[0] == bitonic_roofline_pct.compare_exchanges(e), e
        keys = list(zip(out.tile.tolist(), out.depth.tolist(), out.index.tolist()))
        assert keys == sorted(keys), e


def test_readers_need_their_sections():
    """Without the bitonic sections (a radix frame, the parent's program)
    the three readers give None and raise nothing; with them, the
    sections' ms a frame and a share under 100%."""
    read = {n: metrics.load(n) for n in ("bitonic_shared_ms", "bitonic_global_ms",
                                         "bitonic_roofline_pct")}

    def readings(sections, live=13098506.0):
        return metrics.Readings(10, sections, {}, live, None, 48, None, None)

    radix = readings({"sort": 12.8, "keygen": 12.1})
    assert all(f(radix) is None for f in read.values())
    assert read["bitonic_roofline_pct"](readings({"bitonic_shared": 30.0}, None)) is None
    both = readings({"sort": 55.0, "bitonic_shared": 30.0, "bitonic_global": 25.0})
    assert read["bitonic_shared_ms"](both) == 3.0 and read["bitonic_global_ms"](both) == 2.5
    assert read["bitonic_roofline_pct"](both) == pytest.approx(
        100 * bitonic_roofline_pct.least_ms(13098506.0) / 5.5)
    assert 0 < read["bitonic_roofline_pct"](both) < 100
    assert not read["bitonic_roofline_pct"](readings({"bitonic_global": 25.0}))


@pytest.mark.cuda
def test_pass_sections_on_the_card():
    """On the card: a sort records `bitonic_shared` and `bitonic_global`
    as many times as `schedule` plans (12 and 13 at 2^24), as host spans
    and as CUDA events inside the caller's section; its output is the same
    bit for bit with either timer and without one, and the plain
    version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for e in (1 << 12, 1 << 16, 1 << 24):
        el = _random_elements(e, e, "cuda")
        want = tbk.bitonic_sort(*el[:3])
        planned = collections.Counter(tbk.SECTIONS[p.kind] for p in tbk.launches(e))
        host = CudaPassTimer(device_events=False)
        with host.section("sort"):
            got_host = tbk.bitonic_sort(*el[:3], timer=host)
        counts = host.counts()
        assert {k: counts.get(k, 0) for k in planned} == dict(planned)
        assert all(s.parent == "sort" for s in host.spans() if s.name.startswith("bitonic_"))
        events = CudaPassTimer()
        with events.section("sort"):
            got_events = tbk.bitonic_sort(*el[:3], timer=events)
        totals = events.totals()
        assert set(planned) <= set(totals)
        assert sum(totals[k] for k in planned) <= totals["sort"]
        for got in (got_host, got_events):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        if e == 1 << 24:
            assert dict(planned) == {"bitonic_shared": 12, "bitonic_global": 13}
        else:
            plain = tbit.sort_elements_bitonic_plain(el)
            assert all(torch.equal(a, b) for a, b in zip(want, plain[:3]))
        del el, want, got_host, got_events
