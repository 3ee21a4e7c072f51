"""K1 `expand_rows` (merge-path expansion, csrc/expand.cu) and K2 `blend_tiles`
(reads the frame data itself, csrc/blend.cu).

On the CPU: K2's guards on the frame tensors it reads, and the uncapped
`render_frame` (which calls `blend_tiles`) against the JAX package's
`render_frame` with the Pallas blend (interpret mode), ±1 8-bit step on each
of r, g and b.  On the card (`cuda` marker, skipped without one): K1
bit-exact against `expand_rows_plain` on its edge cases, and K2 against
`blend_rows_plain` within chip_smoke.py's K2 bounds (8-bit max |Δ| <= 2 and
|Δ| > 1 on at most 1e-4 of pixel-channels, each channel on its own) on a
2,048-gaussian cloud with an empty tile, a tile saturated by its first
element and dead (SENTINEL) slots.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk3dgaussiansplatting_tpu import pipeline as jpipe
from vk3dgaussiansplatting_tpu.core.config import RenderConfig
from vk3dgaussiansplatting_tpu.scenes import synthetic as jsyn
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch.core.config import SENTINEL
from vk3dgaussiansplatting_tpu_torch.ops import blend as tblend
from vk3dgaussiansplatting_tpu_torch.ops import keygen as tkg
from vk3dgaussiansplatting_tpu_torch.ops import ranges as tranges
from vk3dgaussiansplatting_tpu_torch.ops import sort as tsort
from vk3dgaussiansplatting_tpu_torch.ops.cuda import blend_kernel as tbk
from vk3dgaussiansplatting_tpu_torch.ops.cuda import expand_kernel as texp
from vk3dgaussiansplatting_tpu_torch.pipeline import render_frame
from vk3dgaussiansplatting_tpu_torch.render.camera import Camera

torch.set_num_threads(1)

CONFIG = RenderConfig(width=192, height=96, capacity_slack_per_tile=32)
# K2 against its plain version (chip_smoke.py's K2_MAX_U8, K2_MAX_FRAC_GT1).
K2_MAX_U8, K2_MAX_FRAC_GT1 = 2, 1e-4


def _cloud(k):
    """A 2,048-gaussian procedural cloud scaled so gaussians cover several
    tiles, and camera k (tests/test_torch_keygen.py's cloud scenes)."""
    pos, rot = [((0.0, 0.0, 2.0), (math.pi, 0.0)), ((0.3, -0.2, 2.5), (3.0, -0.2))][k]
    cam = Camera(CONFIG.aspect)
    cam.set_position(pos)
    cam.set_rotation(*rot)
    table = jsyn.procedural_cloud_table(2048, seed=11)
    return dataclasses.replace(table, scale=table.scale * np.float32(6.0)), cam


def _sorted_frame(table, cam, config):
    view, proj = cam.matrices()
    el, frame = tkg.generate_sort_elements(table, view, proj, cam.position, config,
                                           config.sort_capacity(table.num_gaussians))
    el = tsort.sort_elements(el, config)
    return el, tranges.find_ranges(el, config.num_tiles), frame


def _frame_inputs():
    cfg = convert.config_from_jax(CONFIG)
    table, cam = _cloud(0)
    el, rg, frame = _sorted_frame(convert.table_from_jax(table), cam, cfg)
    return cfg, el, rg, frame


GUARDS = {
    "non_contiguous": lambda f: f._replace(cov_inv=torch.zeros((3, f.cov_inv.shape[0])).t()),
    "wrong_width": lambda f: f._replace(screen_pos=torch.zeros((f.screen_pos.shape[0], 3))),
    "wrong_dtype": lambda f: f._replace(color_alpha=f.color_alpha.double()),
    "row_count": lambda f: f._replace(cov_inv=f.cov_inv[:-1]),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_blend_tiles_rejects_bad_frame(case):
    """A frame tensor K2 cannot read row by row raises (no silent copy)."""
    cfg, el, rg, frame = _frame_inputs()
    bad = GUARDS[case](frame)
    with pytest.raises(ValueError, match="frame"):
        tbk.blend_tiles(el, rg, bad, cfg)


@pytest.mark.parametrize("k", [0, 1])
def test_render_frame_uncapped_matches_jax(k):
    table, cam = _cloud(k)
    view, proj = cam.matrices()
    cap = CONFIG.sort_capacity(table.position.shape[0])
    want = jpipe.render_frame(jax.tree.map(jnp.asarray, table), jnp.asarray(view),
                              jnp.asarray(proj), jnp.asarray(cam.position), config=CONFIG,
                              capacity=cap, use_pallas_blend=True)
    got = render_frame(convert.table_from_jax(table), view, proj, cam.position,
                       config=convert.config_from_jax(CONFIG), capacity=cap)
    assert int(got.num_elements) == int(want.num_elements) > 0
    g, w = got.image_u8.numpy().astype(np.int32), np.asarray(want.image_u8).astype(np.int32)
    for ch in range(3):
        assert np.abs(g[..., ch] - w[..., ch]).max() <= 1, f"channel {ch}"
        assert g[..., ch].sum() > 0, f"channel {ch} is empty"


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 and K2 are CUDA kernels with no CPU mode")


def _expand_cases():
    rng = np.random.default_rng(5)
    mixed = rng.integers(0, 9, size=5000)
    mixed[rng.random(5000) < 0.4] = 0
    huge = np.zeros(3000, np.int64)
    huge[[7, 1500, 2999]] = [12_345, 40_000, 3]  # runs over many blocks
    sparse = np.zeros(1_200_000, np.int64)  # a run of >= 1,000,000 zero counts
    sparse[[0, 600_000, 1_199_999]] = [5, 2, 9]
    return [
        (mixed, int(mixed.sum()) + 301),  # E % 4 != 0 with a dead tail
        (mixed, int(mixed.sum()) // 2 + 2),  # total > E, a run cut
        (huge, 52_351),  # E % 4 != 0
        (huge, 60_000),
        (sparse, 19),
        (sparse, 1024),
        (np.zeros(0, np.int64), 64),  # N = 0
        (np.zeros(700, np.int64), 513),
    ]


@pytest.mark.cuda
def test_expand_kernel_edge_cases_on_cuda():
    _needs_card()
    rng = np.random.default_rng(6)
    for counts, capacity in _expand_cases():
        n = len(counts)
        cols = torch.from_numpy(np.stack([
            np.arange(n, dtype=np.int32),
            rng.integers(-(2**31), 2**31, size=n).astype(np.int32),
            rng.integers(-(2**31), 2**31, size=n).astype(np.int32),
        ])).cuda()
        c = torch.from_numpy(counts).cuda()
        launches = texp.LAUNCHES
        got, total = texp.expand_rows(cols, c, capacity)
        assert texp.LAUNCHES == launches + 1
        want, want_total = texp.expand_rows_plain(cols, c, capacity)
        assert int(total) == int(want_total) == int(counts.sum())
        assert torch.equal(got, want), f"n={n} capacity={capacity}"


@pytest.mark.cuda
def test_blend_tiles_kernel_on_cuda():
    _needs_card()
    cfg, el, rg, frame = _frame_inputs()
    lengths = rg[:, 1] - rg[:, 0]
    rg = rg.clone()
    empty = int(torch.argmax(lengths))
    rg[empty, 1] = rg[empty, 0]  # the busiest tile left empty
    sat = int(torch.argsort(lengths, descending=True)[1])
    # A gaussian covering tile `sat` at full opacity: T < 1e-4 after it.
    first = int(el.index[rg[sat, 0]])
    cx = float((sat % cfg.grid_width) * 16 + 8)
    cy = float((sat // cfg.grid_width) * 16 + 8)
    frame = frame._replace(
        screen_pos=frame.screen_pos.index_put((torch.tensor([first]),), torch.tensor([[cx, cy]])),
        cov_inv=frame.cov_inv.index_put((torch.tensor([first]),), torch.tensor([[1e-9, 0.0, 1e-9]])),
        color_alpha=frame.color_alpha.index_put((torch.tensor([first]),),
                                                torch.tensor([[0.25, 0.5, 0.75, 1.0]])),
    )
    last = int(torch.nonzero(lengths > 0).max())
    rg[last, 1] += 7  # dead SENTINEL slots past the live count
    assert (el.index[rg[last, 0]: rg[last, 1]] == SENTINEL).any()

    dev = lambda x: x.cuda()
    el_c = tkg.SortElements(*(dev(x) for x in el))
    frame_c = tkg.GaussianFrameData(*(dev(x) for x in frame))
    launches = tbk.LAUNCHES
    got = tbk.blend_tiles(el_c, dev(rg), frame_c, cfg)
    assert tbk.LAUNCHES == launches + 1
    want = tblend.blend_rows_plain(tbk.pack_feature_table(frame_c), el_c.index, dev(rg), cfg)
    q = lambda img: torch.round(img * 255.0).to(torch.int32)
    d = (q(got) - q(want)).abs()
    for ch in range(3):
        assert int(d[..., ch].max()) <= K2_MAX_U8, f"channel {ch}"
        assert float((d[..., ch] > 1).float().mean()) <= K2_MAX_FRAC_GT1, f"channel {ch}"
    tiles = got.reshape(cfg.grid_height, 16, cfg.grid_width, 16, 3)
    sat_px = tiles[sat // cfg.grid_width, :, sat % cfg.grid_width]
    assert torch.allclose(sat_px, torch.tensor([0.25, 0.5, 0.75], device="cuda"), atol=1e-4)
