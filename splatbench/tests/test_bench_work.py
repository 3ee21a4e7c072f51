"""The work counts: P against a brute-force count over pixels, and no
share of a least time above 100% where the work is what the port's
interfaces hold."""

import numpy as np
import pytest
import torch

from splatbench import metrics, reference, scene
from splatbench.metrics import work
from splatbench.tests import tiny


@pytest.fixture(scope="module")
def frame():
    torch.set_num_threads(2)
    cfg = tiny.tiny_config()
    fr = reference.frame_constants(cfg["render"], cfg["gaussians"])
    cloud = scene.make_cloud(cfg["gaussians"], cfg["assumed"]["cloud"], 99, "cpu")
    orbit = scene.Orbit(cfg["assumed"]["camera"], fr.width / fr.height, 16, 0.02, 0)
    mult, _ = scene.calibrate(cloud, orbit.centre(), fr, cfg["target_live"], 0.001)
    cloud = scene.scaled(cloud, mult)
    cam = orbit.camera(3)
    view, proj = cam.matrices()
    _img, p, s, rows = reference.render(cloud, view, proj, cam.position, fr)
    return cloud, cam, fr, p, s, rows


def brute_pairs(rows, s, fr):
    """Pixel by pixel, element by element."""
    rows, index, ranges = rows.numpy(), s.index.tolist(), s.ranges.tolist()
    pairs = eligible = 0
    for t, (a, b) in enumerate(ranges):
        tx, ty = t % fr.grid_w, t // fr.grid_w
        for v in range(fr.tile):
            for u in range(fr.tile):
                x, y = tx * fr.tile + u, ty * fr.tile + v
                if x >= fr.width or y >= fr.height:
                    continue
                trans = np.float32(1.0)
                for k in range(a, b):
                    r = rows[index[k]]
                    dx, dy = r[0] - np.float32(x), np.float32(y) - r[1]
                    f = (r[2] * dx * dx + r[4] * dy * dy) + r[3] * dx * dy
                    alpha = r[8] * np.exp(f)
                    pairs += 1
                    if f <= 0 and alpha >= fr.alpha_cutoff:
                        eligible += 1
                        trans = trans * (np.float32(1.0) - alpha)
                        if trans < fr.stop:
                            break
    return pairs, eligible


def test_saturating_pairs_equal_a_brute_force_count(frame):
    _cloud, _cam, fr, _p, s, rows = frame
    # A corner of the image keeps the brute force short: 8 tiles.
    sub = s._replace(ranges=torch.where(torch.arange(fr.tiles)[:, None] < 8, s.ranges, 0))
    got = work.saturating_pairs(rows, sub.index, sub.ranges, width=fr.width, height=fr.height,
                                tile=fr.tile, cutoff=fr.alpha_cutoff, stop=fr.stop)
    want = brute_pairs(rows, sub, fr)
    assert want[0] > 1000 and got == want


def _counts(frame):
    _cloud, _cam, fr, p, s, rows = frame
    pairs, eligible = work.saturating_pairs(
        rows, s.index, s.ranges, width=fr.width, height=fr.height, tile=fr.tile,
        cutoff=fr.alpha_cutoff, stop=fr.stop)
    return {"gaussians": p.counts.shape[0], "visible": int(p.visible.sum()),
            "pixels": fr.width * fr.height, "pairs": pairs, "eligible": eligible}


def test_no_share_passes_100_where_the_work_is_the_interfaces(frame):
    """Each least time is at most the time of what the port's interfaces
    hold at the peak rates (its table, its element list, its frame data,
    its image, every pair of every range), so a stage that moves only those
    reads at most 100%; and a reader fed its own least time reads 100."""
    cloud, _cam, fr, _p, s, _rows = frame
    w = _counts(frame)
    n, live = w["gaussians"], s.live
    table = sum(t.numel() * 4 for t in cloud)
    all_pairs = int((s.ranges[:, 1] - s.ranges[:, 0]).sum()) * fr.tile**2
    assert w["pairs"] <= all_pairs and w["eligible"] <= w["pairs"]
    assert work.keygen_least_ms(w, live) <= work.least_ms(table + 24 * fr.capacity + 48 * n)
    assert work.sort_least_ms(live) <= work.least_ms(2 * 24 * fr.capacity)
    ops = work.FLOPS_PER_PAIR * all_pairs + 10 * w["eligible"]
    assert work.blend_least_ms(w) <= work.least_ms(12 * w["pixels"], ops)
    assert work.frame_least_ms(w) <= (work.keygen_least_ms(w, live) + work.sort_least_ms(live)
                                      + work.blend_least_ms(w))
    sections = {"keygen": work.keygen_least_ms(w, live), "sort": work.sort_least_ms(live),
                "blend": work.blend_least_ms(w)}
    r = metrics.Readings(1, sections, {}, float(live), w, 4, 1.0, work.frame_least_ms(w) * 4e-3)
    for name in ("keygen_roofline_pct", "sort_roofline_pct", "blend_roofline_pct", "frame_mfu"):
        assert metrics.load(name)(r) == pytest.approx(100.0)
    slower = r._replace(window_s=2 * r.window_s, sections={k: 2 * v for k, v in sections.items()})
    for name in ("keygen_roofline_pct", "sort_roofline_pct", "blend_roofline_pct", "frame_mfu"):
        assert metrics.load(name)(slower) == pytest.approx(50.0)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    r = metrics.Readings(10, {"keygen": 12.0}, {"fast": 0, "patch": 0, "full": 0}, None, None,
                         48, None, None)
    for name in ("capped_policy_ms", "patch_frames_pct", "device_idle_pct", "frame_mfu",
                 "sort_ms", "keygen_roofline_pct", "blend_roofline_pct"):
        assert metrics.load(name)(r) is None, name
    assert metrics.load("keygen_ms")(r) == pytest.approx(1.2)
    capped = r._replace(sections={"layout": 1.0, "policy": 2.0, "patch": 3.0},
                        path_counts={"fast": 6, "patch": 3, "full": 1}, busy_s=0.75, window_s=1.0)
    assert metrics.load("capped_policy_ms")(capped) == pytest.approx(0.6)
    assert metrics.load("patch_frames_pct")(capped) == pytest.approx(40.0)
    assert metrics.load("device_idle_pct")(capped) == pytest.approx(25.0)


def test_an_element_is_counted_at_its_least_size():
    """The three keys of a sort element at 4 bytes each: the sort's least
    time is 24 bytes a live element, read once and written once."""
    assert work.ELEMENT_BYTES == 12
    assert work.sort_least_ms(1e6) == pytest.approx(24e6 / work.PEAK_BYTES_PER_S * 1e3)


def test_frame_mfu_reads_the_untimed_slice():
    w = {"gaussians": 1000, "visible": 500, "pixels": 100, "pairs": 0, "eligible": 0}
    r = metrics.Readings(10, {}, {}, None, w, 48, 0.5, 0.48)
    assert r.slice_frame_ms() == pytest.approx(10.0)
    assert metrics.load("frame_mfu")(r) == pytest.approx(10.0 * work.frame_least_ms(w))
    assert metrics.load("frame_mfu")(r._replace(window_s=None)) is None
