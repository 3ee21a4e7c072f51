"""K3 `blend_flat` reading the frame data by id (csrc/blend_flat.cu) and K4
`blend_strip` with its per-pixel stop (csrc/blend_strip.cu), both staging
rows through csrc/blend_rows.cuh with the expf skip; and K2's warp masks
(csrc/blend_rows.cuh:warp_mask, csrc/blend.cu), by which each of K2's
warps walks only the rows it can see.

On the CPU: K3's guards on the frame tensors it reads (K2's cases); a
float32 sweep showing that every pair the skip threshold drops is
ineligible; and a model of K4's per-pixel stop (a rank-stepped loop in
which each pixel stops once T < stop) against `blend_strip_plain` on the
strip fixtures of tests/test_torch_strip_blend.py, saturated carries
included, to K4's criterion (`assert_strip_matches_plain`: colours bit for
bit, log T bit for bit wherever the plain T >= stop, both T below the stop
elsewhere).  K2's warp mask (`warp_masks_plain`, the kernel's arithmetic)
over a sweep of rows, thin, rotated, huge, degenerate and NaN conics,
galpha at the cutoff and centres in, on and far from the tile among them:
no pair K2 takes (f <= 0, f >= thr, galpha * exp(f) >= cutoff, f in
float32 unfused or rounded once from float64) lies under a cleared bit,
and on a sample of garden's stand-in cloud the mask clears at least 60% of
the (warp, row) pairs.  On the card (`cuda` marker, skipped without one): K3
against `blend_flat_plain` bit for bit, image and T, with and without T,
on a packed capped layout with an empty tile, a tile saturated by its
first element, a cap cut, dead SENTINEL slots and a range past the index
array; K2 against `blend_rows_plain` on a frame with long tile lists and
one with saturated tiles, and ptxas's report of `blend_tiles_kernel`.  K4
on the card is tests/test_torch_strip_blend.py's
`test_strip_kernel_matches_plain_on_cuda`, on the same strip cases.
"""

import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from test_torch_kernel_redesign import (
    GUARDS, K2_MAX_FRAC_GT1, K2_MAX_U8, _frame_inputs, _sorted_frame,
)
from test_torch_strip_blend import (
    CONFIG, STRIP_TILES, assert_strip_matches_plain, frame, strip_cases,  # noqa: F401
)
from vk3dgaussiansplatting_tpu_torch import RenderConfig, convert
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import blend as tblend
from vk3dgaussiansplatting_tpu_torch.ops import capped as tcap
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops.cuda import _build
from vk3dgaussiansplatting_tpu_torch.ops.cuda._build import LAUNCHES
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera
from vk3dgaussiansplatting_tpu_torch.scenes import synthetic

torch.set_num_threads(1)

SKIP_MARGIN = np.float32(1e-3)  # csrc/blend_rows.cuh kSkipMargin


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_blend_flat_rejects_bad_frame(case):
    """A frame tensor K3 cannot read row by row raises (no silent copy)."""
    cfg, el, rg, frame_data = _frame_inputs()
    with pytest.raises(ValueError, match="frame"):
        tblend.blend_flat(GUARDS[case](frame_data), el.index, rg, cfg, with_t=True)


def test_skip_threshold_drops_only_ineligible_pairs():
    """thr = log(cutoff / galpha) - 1e-3 in float32: for galpha over (0, 1]
    (1/255, its float neighbours and 1 included), every f below thr gives
    galpha * exp(f) < cutoff, so a skipped pair is never eligible; and thr
    is tight: 2e-3 above it the pair is eligible again."""
    cutoff = np.float32(1.0 / 255.0)
    galpha = np.concatenate([
        np.geomspace(1e-7, 1.0, 4001).astype(np.float32),
        [cutoff, np.nextafter(cutoff, np.float32(0)), np.nextafter(cutoff, np.float32(1)),
         np.float32(0.5), np.float32(1.0), np.nextafter(np.float32(1.0), np.float32(0))],
    ]).astype(np.float32)
    ga = torch.from_numpy(galpha)
    thr = torch.log(torch.tensor(cutoff) / ga) - torch.tensor(SKIP_MARGIN)
    below = [thr.numpy()]  # floats just under thr, and a spread further down
    for _ in range(64):
        below.append(np.nextafter(below[-1], np.float32(-np.inf)))
    below += [thr.numpy() - np.float32(d) for d in (1e-4, 1e-3, 0.01, 0.1, 1.0, 10.0, 100.0)]
    f = torch.from_numpy(np.stack(below[1:], axis=1))  # [galpha, probes], all < thr
    assert bool((f < thr[:, None]).all())
    f = torch.minimum(f, torch.tensor(0.0))  # f > 0 is ineligible on its own
    alpha = ga[:, None] * torch.exp(f)
    assert bool((alpha < torch.tensor(cutoff)).all()), float(alpha.max())
    tight = galpha >= cutoff * np.float32(1.01)
    above = torch.minimum(thr + torch.tensor(np.float32(2e-3)), torch.tensor(0.0))
    assert bool((ga * torch.exp(above) >= torch.tensor(cutoff))[torch.from_numpy(tight)].all())


def _per_pixel_stop_model(rows, index, ranges, cfg, *, tile_base, carry_color, carry_logt,
                          gather):
    """K4's kernel as a rank-stepped loop: step r blends slot start + r of
    every tile, each pixel stops once its T < stop (no batches)."""
    p = cfg.tile_size**2
    stop, cutoff = cfg.transmittance_stop, cfg.alpha_cutoff
    e, n_tiles = index.shape[0], ranges.shape[0]
    tiles = tile_base + torch.arange(n_tiles)
    pix = torch.arange(p)
    px = ((tiles % cfg.grid_width)[:, None] * cfg.tile_size + pix % cfg.tile_size).float()
    py = ((tiles // cfg.grid_width)[:, None] * cfg.tile_size + pix // cfg.tile_size).float()
    start = ranges[:, 0]
    length = torch.clamp(ranges[:, 1] - start, min=0)
    trans, color = torch.exp(carry_logt), carry_color.clone()
    done = ~(trans >= stop)
    for r in range(int(length.max())):
        act = torch.nonzero((r < length) & ~done.all(dim=1)).squeeze(1)
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
        t_act = trans[act]
        elig = (f <= 0.0) & (alpha >= cutoff) & ~done[act]
        color[act] += torch.where(elig, t_act * alpha, 0.0)[:, :, None] * row[:, None, 6:9]
        t_new = torch.where(elig, t_act * (1.0 - alpha), t_act)
        trans[act] = t_new
        done[act] |= t_new < stop
    return color, torch.log(trans)


def test_per_pixel_stop_model_matches_plain(frame):  # noqa: F811
    _, (te, tr, tf) = frame
    cfg = convert.config_from_jax(CONFIG)
    differs = False
    for rows, gather, tile_base, cc, cl in strip_cases(te, tf):
        kw = dict(tile_base=tile_base, carry_color=cc, carry_logt=cl, gather=gather)
        ranges = tr[tile_base : tile_base + STRIP_TILES]
        got = _per_pixel_stop_model(rows, te.index, ranges, cfg, **kw)
        want = tblend.blend_strip_plain(rows, te.index, ranges, cfg, **kw)
        assert_strip_matches_plain(got, want, cfg.transmittance_stop)
        differs |= not torch.equal(got[1], want[1])
    assert differs  # the per-pixel stop leaves some T above the plain one


# A 1080p grid for the mask sweep (tile coordinates up to 1904, 1072).
MASK_CONFIG = RenderConfig(width=1920, height=1080)
GARDEN_GAUSSIANS, GARDEN_SCALE = 5_834_784, 0.4512  # splatbench's garden30k_1080p


def _pixels(tiles, cfg):
    ts = cfg.tile_size
    pix = torch.arange(ts * ts)
    px = ((tiles % cfg.grid_width)[:, None] * ts + pix % ts).float()
    py = ((tiles // cfg.grid_width)[:, None] * ts + pix // ts).float()
    return px, py


def _thr(rows, cfg):
    cutoff = torch.tensor(cfg.alpha_cutoff, dtype=torch.float32)
    return torch.log(cutoff / rows[:, 9:10]) - tblend.SKIP_MARGIN


def _taken(rows, tiles, cfg):
    """[R, 256]: the (row, pixel) pairs K2's loop takes (f <= 0, f >= thr,
    galpha * exp(f) >= cutoff), with f in float32 as written or rounded
    once from float64 (the fused extreme), either way."""
    px, py = _pixels(tiles, cfg)
    gx, gy, a, b, c, galpha = (rows[:, k : k + 1] for k in (0, 1, 2, 3, 4, 9))
    dx, dy = gx - px, py - gy
    d = [x.double() for x in (a, b, c, dx, dy)]
    thr = _thr(rows, cfg)
    cutoff = torch.tensor(cfg.alpha_cutoff, dtype=torch.float32)
    taken = torch.zeros(dx.shape, dtype=torch.bool)
    for f in ((a * dx * dx + c * dy * dy) + b * dx * dy,
              ((d[0] * d[3] * d[3] + d[2] * d[4] * d[4]) + d[1] * d[3] * d[4]).float()):
        taken |= (f <= 0) & (f >= thr) & (galpha * torch.exp(f) >= cutoff)
    return taken


def _warp_of_pixel():
    """[256]: K2's warp of each tile pixel v * 16 + u."""
    out = torch.empty(256, dtype=torch.int64)
    out[tblend.WARP_PIXELS.flatten()] = torch.arange(tblend.WARPS).repeat_interleave(32)
    return out


def _under_cleared(mask):
    """[R, 256]: the pixels whose warp's bit is clear in their row's mask."""
    bits = (mask.long()[:, None] >> torch.arange(tblend.WARPS)) & 1
    return (bits == 0)[:, _warp_of_pixel()]


def _warp_peaks64(rows, tiles, cfg):
    """[R, 8] float64: f's exact maximum over each warp's four pixel rows
    (dx over its eight columns, continuous)."""
    r = rows.double()
    ts = cfg.tile_size
    x0 = ((tiles % cfg.grid_width) * ts).double()[:, None]
    y0 = ((tiles // cfg.grid_width) * ts).double()[:, None]
    gx, gy, a, b, c = (r[:, k : k + 1] for k in range(5))
    e = y0 + torch.arange(ts, dtype=torch.float64) - gy
    halves = []
    for first in (0, 8):  # the left and the right warp of each band
        dx = torch.clamp(-0.5 * b * e / a, gx - x0 - first - 7, gx - x0 - first)
        peak = a * dx * dx + b * dx * e + c * e * e
        halves.append(peak.reshape(-1, 4, 4).amax(dim=2))
    return torch.stack(halves, dim=2).reshape(-1, tblend.WARPS)


def _sweep_rows(rng, cfg, n):
    """[n, 10] float32 rows and [n] tiles: centres in, on the edge of
    (and between warps and pixels), near and far outside the tile; conics of
    scales 0.05 to 3000 px at any angle; galpha at the cutoff, its float
    neighbour, spread to 1, below it and 0 (a dead row); then degenerate,
    non-finite and huge conics, and rows whose thr sits within +-3e-3 of a
    warp's largest f at its pixels."""
    gw = cfg.grid_width
    tiles = rng.integers(0, cfg.num_tiles, n)
    x0, y0 = (tiles % gw) * 16.0, (tiles // gw) * 16.0
    kind = rng.integers(0, 4, n)
    off = rng.uniform(-0.5, 15.5, (n, 2))
    on = kind == 1
    off[on] = rng.choice([0.0, 15.0, 7.5, 3.5, 11.5, -0.5, 15.5, 0.5, 8.5, 14.5, -1e-3, 15.001],
                         size=(on.sum(), 2))
    off[kind == 2] = rng.uniform(-60.0, 76.0, ((kind == 2).sum(), 2))
    far = kind == 3
    off[far] = rng.choice([-1.0, 1.0], (far.sum(), 2)) * np.exp(
        rng.uniform(math.log(100.0), math.log(1e5), (far.sum(), 2)))
    s1, s2 = np.exp(rng.uniform(math.log(0.05), math.log(3e3), (2, n)))
    th = rng.uniform(0.0, math.pi, n)
    i1, i2, co, si = 1.0 / s1**2, 1.0 / s2**2, np.cos(th), np.sin(th)
    ia, ib, ic = co * co * i1 + si * si * i2, co * si * (i1 - i2), si * si * i1 + co * co * i2
    cutoff = np.float32(cfg.alpha_cutoff)
    galpha = np.exp(rng.uniform(math.log(cutoff), 0.0, n))
    pick = rng.integers(0, 8, n)
    galpha[pick == 0] = cutoff
    galpha[pick == 1] = np.nextafter(cutoff, np.float32(1))
    galpha[pick == 2] = 1.0
    galpha[pick == 3] = cutoff * 0.9
    galpha[pick == 4] = 0.0
    rows = np.zeros((n, 10), np.float32)
    rows[:, 0], rows[:, 1] = x0 + off[:, 0], y0 + off[:, 1]
    rows[:, 2], rows[:, 3], rows[:, 4] = -ia / 2, -ib, -ic / 2
    rows[:, 6:9] = 0.5
    rows[:, 9] = galpha

    # Degenerate, non-finite and huge conics.
    odd = rng.random(n) < 0.08
    for i in np.nonzero(odd)[0]:
        case = rng.integers(0, 8)
        if case == 0:
            rows[i, 2] = rng.choice([0.0, 0.5, -1e-35])  # a' >= 0, or below MIN_CONIC
        elif case == 1:
            rows[i, 4] = rng.choice([0.0, 0.25])  # c' >= 0
        elif case == 2:
            rows[i, 2:5] = [-1.0, 2.0, -1.0]  # 4a'c' = b'^2
        elif case == 3:
            rows[i, 2:5] = [-0.01, 0.03, -0.02]  # indefinite
        elif case == 4:
            rows[i, rng.choice([0, 1, 2, 3, 4, 9])] = np.nan
        elif case == 5:
            rows[i, rng.choice([0, 1, 2, 3, 4])] = rng.choice([np.inf, -np.inf])
        elif case == 6:
            rows[i, 2:5] = [-1e6, 1e5, -3e6]  # a point
        else:
            rows[i, 2:5] = [-1e-9, 1e-10, -2e-9]  # a plane
    rows_t, tiles_t = torch.from_numpy(rows), torch.from_numpy(tiles)

    # thr at a warp's largest f at its pixels, +-3e-3 (thr = log(cutoff / galpha) - 1e-3).
    px, py = _pixels(tiles_t, cfg)
    r = rows_t.double()
    f = ((r[:, 2:3] * (r[:, 0:1] - px) ** 2 + r[:, 4:5] * (py - r[:, 1:2]) ** 2)
         + r[:, 3:4] * (r[:, 0:1] - px) * (py - r[:, 1:2]))
    wmax = f[:, tblend.WARP_PIXELS].amax(dim=2)[torch.arange(n),
                                                 torch.from_numpy(rng.integers(0, 8, n))]
    delta = torch.from_numpy(rng.choice([-3e-3, -1e-3, -5e-4, -1e-4, 0.0, 1e-4, 1e-3, 3e-3], n))
    ga = float(cutoff) * torch.exp(-(wmax + delta + tblend.SKIP_MARGIN))
    edge = torch.from_numpy(~odd & (rng.random(n) < 0.4)) & (ga > 0) & (ga <= 1)
    rows_t[edge, 9] = ga[edge].float()
    return rows_t, tiles_t


def _garden_sample():
    """garden30k_1080p's stand-in cloud (chip_smoke.py's, with the
    benchmark's calibrated scale) at 1/128 of its gaussians, at its
    centre pose: feature rows and tiles of the sorted live elements."""
    cfg = RenderConfig(width=1920, height=1080, capacity_slack_per_tile=16)
    table = synthetic.procedural_cloud_table(GARDEN_GAUSSIANS // 128, seed=7,
                                             opacity_mode="capture")
    table = dataclasses.replace(table, scale=table.scale * float(np.float32(GARDEN_SCALE)))
    cam = Camera(cfg.aspect)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(math.pi, 0.0)
    el, _, frame = _sorted_frame(table, cam, cfg)
    n = int(el.count)
    assert n < el.index.shape[0]  # nothing clamped
    idx = el.index[:n]
    assert bool((idx != SENTINEL).all())
    return tblend.pack_feature_table(frame)[idx], el.tile[:n], cfg


def test_warp_mask_hides_no_taken_pair():
    """warp_masks_plain over the sweep and over garden's sample: no pair K2
    takes lies under a cleared bit; degenerate and non-finite conics keep
    every bit, dead rows none; the mask is tight (a warp whose exact peak
    is 0.01 below thr loses its bit where the margin is small), the sweep
    reaches the boundary, and at garden the mask clears >= 60% of the
    (warp, row) pairs."""
    cfg = MASK_CONFIG
    rows, tiles = _sweep_rows(np.random.default_rng(26), cfg, 24_000)
    mask = tblend.warp_masks_plain(rows, tiles, cfg)
    taken = _taken(rows, tiles, cfg)
    under = _under_cleared(mask)
    assert not bool((taken & under).any()), int((taken & under).sum())
    assert int(taken.sum()) > 100_000

    thr = _thr(rows, cfg)[:, 0]
    a, b, c = rows[:, 2], rows[:, 3], rows[:, 4]
    regular = (torch.isfinite(rows[:, :5]).all(dim=1) & (a < -tblend.MIN_CONIC) & (c < 0)
               & (4 * a * c > b * b))
    assert bool((mask[~regular & ~(thr > 0)] == 0xFF).all())
    assert bool((mask[rows[:, 9] == 0] == 0).all()) and bool((rows[:, 9] == 0).any())
    peaks = _warp_peaks64(rows, tiles, cfg)
    x0, y0 = (tiles % cfg.grid_width) * 16.0, (tiles // cfg.grid_width) * 16.0
    mx = torch.maximum((rows[:, 0] - x0).abs(), (rows[:, 0] - x0 - 15).abs()).double()
    my = torch.maximum((rows[:, 1] - y0).abs(), (rows[:, 1] - y0 - 15).abs()).double()
    terms = (b.abs().double() * my - a.double() * mx) * mx - c.double() * my * my
    small = regular & (terms * tblend.MASK_MARGIN < 1e-3) & (thr <= 0)
    low = small[:, None] & (peaks < thr.double()[:, None] - 0.01)
    bits = ((mask.long()[:, None] >> torch.arange(tblend.WARPS)) & 1).bool()
    assert bool((~bits[low]).all()) and int(low.sum()) > 10_000
    cleared_near = ~bits & (peaks >= thr.double()[:, None] - 0.01)
    assert int(cleared_near.sum()) > 100  # cleared bits right at the boundary

    rows, tiles, cfg = _garden_sample()
    mask = tblend.warp_masks_plain(rows, tiles, cfg)
    cleared = 1.0 - float(((mask.long()[:, None] >> torch.arange(8)) & 1).sum()) / (8 * len(mask))
    assert cleared >= 0.6, cleared
    for i in range(0, len(rows), 16_384):
        sl = slice(i, i + 16_384)
        hidden = _taken(rows[sl], tiles[sl], cfg) & _under_cleared(mask[sl])
        assert not bool(hidden.any()), int(hidden.sum())


@pytest.mark.cuda
def test_blend_flat_kernel_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K3 is a CUDA kernel with no CPU mode")
    cfg, el, rg, frame_data = _frame_inputs()
    lengths = rg[:, 1] - rg[:, 0]
    # A gaussian covering tile `sat` at full opacity: its first element
    # saturates every pixel.
    sat = int(torch.argsort(lengths, descending=True)[1])
    first = int(el.index[rg[sat, 0]])
    cx, cy = float((sat % cfg.grid_width) * 16 + 8), float((sat // cfg.grid_width) * 16 + 8)
    frame_data = frame_data._replace(
        screen_pos=frame_data.screen_pos.index_put((torch.tensor([first]),),
                                                   torch.tensor([[cx, cy]])),
        cov_inv=frame_data.cov_inv.index_put((torch.tensor([first]),),
                                             torch.tensor([[1e-9, 0.0, 1e-9]])),
        color_alpha=frame_data.color_alpha.index_put((torch.tensor([first]),),
                                                     torch.tensor([[0.25, 0.5, 0.75, 1.0]])),
    )
    for batch_k in (128, 768):
        c = dataclasses.replace(cfg, blend_batch_k=batch_k)
        caps = torch.full((c.num_tiles,), 1024, dtype=torch.int64)
        lay = tcap.capped_layout(el, rg, frame_data, c, caps)
        gid = lay.gid.clone()
        pranges = torch.stack([lay.pstart, lay.pstart + lay.counts], dim=1)
        empty = int(torch.argmax(lengths))
        pranges[empty, 1] = pranges[empty, 0]  # the busiest tile left empty
        third = int(torch.argsort(lengths, descending=True)[2])
        gid[pranges[third, 0] + 3 : pranges[third, 0] + 40 : 4] = SENTINEL  # dead slots inside
        last = max(i for i in torch.nonzero(lay.counts > 0).squeeze(1).tolist()
                   if i not in (empty, sat, third))
        pranges[last] = torch.tensor([gid.shape[0] - 5, gid.shape[0] + 60])  # past the array
        frame_c = tkg.GaussianFrameData(*(x.cuda() for x in frame_data))
        gid_c, pr_c = gid.cuda(), pranges.cuda()
        table = tblend.pack_feature_table(frame_c)
        for cap in (0, 50):
            for with_t in (False, True):
                launches = LAUNCHES["blend_flat"]
                got = tblend.blend_flat(frame_c, gid_c, pr_c, c, cap=cap, with_t=with_t)
                assert LAUNCHES["blend_flat"] == launches + 1
                want = tblend.blend_flat_plain(table, gid_c, pr_c, c, cap=cap, with_t=with_t)
                for a, b in zip(got, want) if with_t else ((got, want),):
                    assert torch.equal(a, b), (batch_k, cap, with_t)
        img, t = tblend.blend_flat(frame_c, gid_c, pr_c, c, with_t=True)
        assert bool((t[empty] == 1.0).all()) and bool((t[sat] < c.transmittance_stop).all())
        tiles = img.reshape(c.grid_height, 16, c.grid_width, 16, 3)
        sat_px = tiles[sat // c.grid_width, :, sat % c.grid_width]
        assert torch.allclose(sat_px, torch.tensor([0.25, 0.5, 0.75], device="cuda"), atol=1e-4)


# blend_tiles_kernel's registers at most: 40 a thread (allocated in steps of
# 8) keep six 256-thread blocks on an SM's 65,536 registers, the occupancy
# its pair loop is tuned at.
K2_MAX_REGISTERS = 40


def _ptxas_entry(kernel):
    """ptxas's lines for `kernel` in the built library's report."""
    report = _build.library_path().with_suffix(".log").read_text()
    parts = re.split(r"Compiling entry function '", report)
    found = [p for p in parts[1:] if kernel in p.split("'")[0]]
    assert len(found) == 1, f"{kernel}: {len(found)} entries in the ptxas report"
    return found[0]


@pytest.mark.cuda
def test_blend_tiles_warp_lists_on_cuda():
    """K2, whose warps walk their compacted row lists, against
    blend_rows_plain within K2's bounds on a 30,000-gaussian cloud at
    192x96 (tile lists up to ~4,800 rows, 19 stages): faint gaussians
    (opacity 0.01: most pixels never saturate, every stage is walked) and
    opaque ones (0.99: tiles and warps saturate part way), dead SENTINEL
    slots in one range; then ptxas's report of blend_tiles_kernel: no
    spill, no stack, at most K2_MAX_REGISTERS registers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is a CUDA kernel with no CPU mode")
    cfg = RenderConfig(width=192, height=96, capacity_slack_per_tile=2048)
    table = synthetic.procedural_cloud_table(30_000, seed=3, opacity_mode="capture")
    cam = Camera(cfg.aspect)
    cam.set_position((0.0, 0.0, 2.0))
    cam.set_rotation(math.pi, 0.0)
    q = lambda img: torch.round(img * 255.0).to(torch.int32)
    for opacity in (0.01, 0.99):
        t = dataclasses.replace(table, scale=table.scale * 8.0,
                                opacity=torch.full_like(table.opacity, opacity))
        el, rg, frame = _sorted_frame(t, cam, cfg)
        lengths = rg[:, 1] - rg[:, 0]
        assert int(lengths.max()) > 16 * 256
        rg = rg.clone()
        last = int(torch.nonzero(lengths > 0).max())
        rg[last, 1] += 300  # dead SENTINEL slots past the live count
        el_c = tkg.SortElements(*(x.cuda() for x in el))
        frame_c = tkg.GaussianFrameData(*(x.cuda() for x in frame))
        rg_c = rg.cuda()
        launches = LAUNCHES["blend_tiles"]
        got = tblend.blend_tiles(el_c, rg_c, frame_c, cfg)
        assert LAUNCHES["blend_tiles"] == launches + 1
        want = tblend.blend_rows_plain(tblend.pack_feature_table(frame_c), el_c.index, rg_c, cfg)
        d = (q(got) - q(want)).abs()
        for ch in range(3):
            assert int(d[..., ch].max()) <= K2_MAX_U8, (opacity, ch)
            assert float((d[..., ch] > 1).float().mean()) <= K2_MAX_FRAC_GT1, (opacity, ch)
            assert float(got[..., ch].sum()) > 0, (opacity, ch)
        assert torch.equal(got, tblend.blend_tiles(el_c, rg_c, frame_c, cfg))  # repeatable
    entry = _ptxas_entry("blend_tiles_kernel")
    assert "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" in entry, entry
    registers = int(re.search(r"Used (\d+) registers", entry).group(1))
    assert registers <= K2_MAX_REGISTERS, entry
