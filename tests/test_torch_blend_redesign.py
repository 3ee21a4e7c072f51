"""K3 `blend_flat` reading the frame data by id (csrc/blend_flat.cu) and K4
`blend_strip` with its per-pixel stop (csrc/blend_strip.cu), both staging
rows through csrc/blend_rows.cuh with the expf skip.

On the CPU: K3's guards on the frame tensors it reads (K2's cases); a
float32 sweep showing that every pair the skip threshold drops is
ineligible; and a model of K4's per-pixel stop (a rank-stepped loop in
which each pixel stops once T < stop) against `blend_strip_plain` on the
strip fixtures of tests/test_torch_strip_blend.py, saturated carries
included, to K4's criterion (`assert_strip_matches_plain`: colours bit for
bit, log T bit for bit wherever the plain T >= stop, both T below the stop
elsewhere).  On the card (`cuda` marker, skipped without one): K3
against `blend_flat_plain` bit for bit, image and T, with and without T,
on a packed capped layout with an empty tile, a tile saturated by its
first element, a cap cut, dead SENTINEL slots and a range past the index
array.  K4 on the card is tests/test_torch_strip_blend.py's
`test_strip_kernel_matches_plain_on_cuda`, on the same strip cases.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_kernel_redesign import GUARDS, _frame_inputs
from test_torch_strip_blend import (
    CONFIG, STRIP_TILES, assert_strip_matches_plain, frame, strip_cases,  # noqa: F401
)
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import blend as tblend
from vk3dgaussiansplatting_tpu_torch.ops import capped as tcap
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops.cuda import blend_kernel as tbk

torch.set_num_threads(1)

SKIP_MARGIN = np.float32(1e-3)  # csrc/blend_rows.cuh kSkipMargin


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_blend_flat_rejects_bad_frame(case):
    """A frame tensor K3 cannot read row by row raises (no silent copy)."""
    cfg, el, rg, frame_data = _frame_inputs()
    with pytest.raises(ValueError, match="frame"):
        tbk.blend_flat(GUARDS[case](frame_data), el.index, rg, cfg, with_t=True)


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
        table = tbk.pack_feature_table(frame_c)
        for cap in (0, 50):
            for with_t in (False, True):
                launches = tbk.FLAT_LAUNCHES
                got = tbk.blend_flat(frame_c, gid_c, pr_c, c, cap=cap, with_t=with_t)
                assert tbk.FLAT_LAUNCHES == launches + 1
                want = tblend.blend_flat_plain(table, gid_c, pr_c, c, cap=cap, with_t=with_t)
                for a, b in zip(got, want) if with_t else ((got, want),):
                    assert torch.equal(a, b), (batch_k, cap, with_t)
        img, t = tbk.blend_flat(frame_c, gid_c, pr_c, c, with_t=True)
        assert bool((t[empty] == 1.0).all()) and bool((t[sat] < c.transmittance_stop).all())
        tiles = img.reshape(c.grid_height, 16, c.grid_width, 16, 3)
        sat_px = tiles[sat // c.grid_width, :, sat % c.grid_width]
        assert torch.allclose(sat_px, torch.tensor([0.25, 0.5, 0.75], device="cuda"), atol=1e-4)
