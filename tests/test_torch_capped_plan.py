"""Port parity of the capped path above its layout and blend: the branch
taken when tiles fail (patch pass, full fallback), the static cap,
`ChainedTemporalPlan` and `Renderer` with `blend_depth_cap > 0`, against the
JAX package (Pallas in interpret mode) on the same numpy-built scenes; and
the capped path's guards (no JAX at run time, wrappers that refuse what
their kernels do not take).

The plan and Renderer tests run the walled scene of tests/test_prefilter.py
(tests/test_torch_prefilter.py rebuilds it): warm-up, the steady switch
(prefiltered keygen at the smaller capacity), steady overflows and the
8-frame revert, a declined switch, and the monolithic temporal frame.

Bounds: CapsState (caps, thresholds, floors), ok flags, stats, modes and
live counts equal; images float |Δ| <= 2e-3 and 8-bit ±1 on each of r, g
and b (docs/TOLERANCES.md).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_capped import (
    BASE, DEEP, TEMPORAL, assert_image_close, assert_state_equal, prepare, stacked_table,
)
from test_torch_prefilter import CONFIG, _camera, walled_scene
from vk3dgaussiansplatting_tpu import pipeline as jpipe
from vk3dgaussiansplatting_tpu.ops import capped as jcap
from vk3dgaussiansplatting_tpu_torch import convert
from vk3dgaussiansplatting_tpu_torch import pipeline as tpipe
from vk3dgaussiansplatting_tpu_torch.core.config import RenderConfig
from vk3dgaussiansplatting_tpu_torch.ops import capped as tcap
from vk3dgaussiansplatting_tpu_torch.ops.cuda import blend_kernel as tbk
from vk3dgaussiansplatting_tpu_torch.ops.cuda import expand_kernel
from vk3dgaussiansplatting_tpu_torch.ops.keygen import GaussianFrameData

torch.set_num_threads(1)
SENTINEL = 0xFFFFFFFF
REPO = Path(__file__).resolve().parent.parent


def test_patch_pass_matches_jax():
    """A handful of invalid tiles: the patch pass re-blends them at full
    range and merges them in."""
    config = dataclasses.replace(TEMPORAL, width=96, height=80)
    (jel, jrg, jfr), (te, tr, tf) = prepare(stacked_table(40, opacity=0.01), config)
    rng = np.random.default_rng(2)
    valid = np.ones(config.num_tiles, bool)
    valid[rng.choice(config.num_tiles, 5, replace=False)] = False
    img = rng.uniform(0, 1, (config.height, config.width, 3)).astype(np.float32)
    jax_patch = jax.jit(jcap._patch_pass, static_argnames=("config",))
    want = jax_patch(jnp.asarray(img), jnp.asarray(valid), jel, jrg, jfr, config)
    tcfg = convert.config_from_jax(config)
    got = tcap._patch_pass(torch.from_numpy(img), torch.from_numpy(valid), te, tr, tf, tcfg)
    assert_image_close(got, want, "patch pass")
    assert not np.array_equal(got.numpy(), img)


def test_translucent_static_cap_falls_back():
    """blend_tiles_capped (static cap): the translucent stack never
    saturates, so the frame takes the full blend; the opaque one validates."""
    tcfg = convert.config_from_jax(BASE)
    for opacity in (0.01, 0.95):
        (jel, jrg, jfr), (te, tr, tf) = prepare(stacked_table(40, opacity), BASE)
        want = jax.jit(jcap.blend_tiles_capped, static_argnames=("config",))(jel, jrg, jfr, BASE)
        got = tcap.blend_tiles_capped(te, tr, tf, tcfg)
        assert_image_close(got, want, f"static cap, opacity {opacity}")
        full = tbk.blend_tiles_flat(te, tr, tf, tcfg)
        if opacity == 0.01:
            assert torch.equal(got, full)


def test_packed_capacities_match_jax():
    for cfg in (BASE, TEMPORAL, DEEP, dataclasses.replace(DEEP, packed_slack_per_tile=512)):
        tcfg = convert.config_from_jax(cfg)
        for capacity in (1000, 100_000, 5_000_000):
            assert tcap.packed_capacity(tcfg, capacity) == jcap.packed_capacity(cfg, capacity)
            assert (tcap.packed_capacity_temporal(tcfg, capacity)
                    == jcap.packed_capacity_temporal(cfg, capacity))


def _inputs(n_front=1200, n_back=600):
    table = walled_scene(n_front=n_front, n_back=n_back)
    cam = _camera(0)
    view, proj = cam.matrices()
    jargs = (jax.tree.map(jnp.asarray, table), jnp.asarray(view), jnp.asarray(proj),
             jnp.asarray(cam.position))
    targs = (convert.table_from_jax(table), view, proj, cam.position)
    return table, cam, jargs, targs


def _assert_frame_equal(tplan, jplan, timg, jimg, what):
    assert_image_close(timg, jimg, what)
    assert_state_equal(tplan.state, jplan.state, what)
    assert bool(tplan.last_ok) == bool(jplan.last_ok), what
    assert int(tplan.last_count) == int(jplan.last_count), what
    np.testing.assert_array_equal(tplan.last_stats.numpy(), np.asarray(jplan.last_stats),
                                  err_msg=what)


def test_chained_plan_steady_switch_matches_jax():
    _table, _cam, jargs, targs = _inputs()
    capacity = CONFIG.sort_capacity(int(jargs[0].position.shape[0]))
    jplan = jpipe.ChainedTemporalPlan(CONFIG, capacity, steady_frac=0.9)
    tplan = tpipe.ChainedTemporalPlan(convert.config_from_jax(CONFIG), capacity, device="cpu",
                                      steady_frac=0.9)
    assert tplan.steady_capacity == jplan.steady_capacity
    full_count = None
    for i in range(8):  # warm-up at full capacity, unfiltered keygen
        _assert_frame_equal(tplan, jplan, tplan.frame(*targs), jplan.frame(*jargs), f"warm {i}")
        full_count = int(tplan.last_count)
    assert (tplan.state.thr != SENTINEL).sum() > CONFIG.num_tiles // 2  # thresholds published
    logs = []
    tplan._log = logs.append
    assert jplan.try_steady_switch(*jargs)
    launches = expand_kernel.STREAMED_LAUNCHES
    assert tplan.try_steady_switch(*targs), logs
    assert expand_kernel.STREAMED_LAUNCHES == launches  # CPU tensors: plain version
    assert tplan.mode == jplan.mode == "steady" and len(logs) == 3
    tplan.keep_intermediates = jplan.keep_intermediates = True
    for i in range(2):
        _assert_frame_equal(tplan, jplan, tplan.frame(*targs), jplan.frame(*jargs), f"steady {i}")
        assert not bool(tplan.last_overflow)
    # The kept intermediates are the last frame's sorted elements and ranges.
    jplan.materialize_intermediates()
    el, rg, _fr = tplan.materialize_intermediates()
    for name in ("tile", "depth", "index"):
        np.testing.assert_array_equal(getattr(el, name).numpy(),
                                      np.asarray(getattr(jplan.last_elements, name)).astype(np.int64))
    np.testing.assert_array_equal(rg.numpy(), np.asarray(jplan.last_ranges).astype(np.int64))
    assert int(tplan.last_count) < full_count  # the prefilter drops the occluded clutter
    assert bool(tplan.last_ok)


def test_steady_overflow_is_flagged_and_switch_declines():
    """As tests/test_prefilter.py:456-491: an infeasible switch is declined
    once and not re-probed; a forced steady frame at a tiny capacity
    overflows, flags ok False, and the device accumulator pops once."""
    _table, _cam, _jargs, targs = _inputs()
    capacity = CONFIG.sort_capacity(int(targs[0].num_gaussians))
    logs = []
    plan = tpipe.ChainedTemporalPlan(convert.config_from_jax(CONFIG), capacity, device="cpu",
                                     steady_frac=0.05, log=logs.append)
    for _ in range(4):
        plan.frame(*targs)
    assert not plan.try_steady_switch(*targs)
    assert plan.steady_declined
    n_logs = len(logs)
    assert not plan.try_steady_switch(*targs)
    assert len(logs) == n_logs  # no re-probe, no new log line
    plan.mode = "steady"
    plan.frame(*targs)
    assert bool(plan.last_overflow)
    assert not bool(plan.last_ok)
    acc = plan.take_overflow_acc()
    assert acc is not None and bool(acc)
    assert plan.take_overflow_acc() is None


def test_renderer_chained_plan_matches_jax(monkeypatch):
    """Renderer(blend_depth_cap > 0) on the chained plan (BIG_SCENE_CAPACITY
    lowered, 4 warm-up frames), camera moving, against JAX's
    Renderer(use_pallas_blend=True): the same frames, live counts and ok
    flags; then a steady overflow reverts the plan to
    the full set within two 8-frame windows."""
    table, cam, _jargs, _targs = _inputs()
    for cls in (jpipe.Renderer, tpipe.Renderer):
        monkeypatch.setattr(cls, "BIG_SCENE_CAPACITY", 1)
        monkeypatch.setattr(cls, "WARMUP_FRAMES", 4)
    jr = jpipe.Renderer(CONFIG, use_pallas_blend=True, steady_frac=0.9)
    jr.init_for_scene(table)
    tr = tpipe.Renderer(convert.config_from_jax(CONFIG), device="cpu", steady_frac=0.9)
    tr.init_for_scene(convert.table_from_jax(table))
    assert tr._plan is not None
    base = cam.position.copy()
    for i in range(6):  # the camera moves 1e-3 a frame
        cam.set_position(base + np.float32([1e-3 * i, 0.0, 0.0]))
        j, t = jr.draw(cam), tr.draw(cam)
        assert_image_close(t.image, j.image, f"renderer frame {i}")
        for ch in range(3):
            d = np.abs(t.image_u8.numpy()[..., ch].astype(int)
                       - np.asarray(j.image_u8)[..., ch].astype(int))
            assert d.max() <= 1
        assert bool(t.ok) == bool(j.ok) and int(t.num_elements) == int(j.num_elements)
    assert tr._plan.mode == jr._plan.mode == "steady" and bool(t.ok)

    plan = tr._plan
    plan.steady_capacity = 512
    flagged = reverted = False
    for _ in range(24):
        out = tr.draw(cam)
        flagged |= not bool(out.ok)
        if plan.mode == "full":
            reverted = True
            break
    assert flagged and reverted and not plan.steady_declined


def test_renderer_steady_overflow_reverts_like_jax(monkeypatch):
    """The camera dollies 0.06 a frame into the scene after the steady
    switch: prefiltered tiles fail validation under the motion (ok False),
    the filtered list outgrows a steady capacity sized just above it at the
    switch, and the 8-frame check reverts to the full set.  JAX's Renderer
    and the port's take every step on the same frame."""
    table, cam, _jargs, _targs = _inputs()
    for cls in (jpipe.Renderer, tpipe.Renderer):
        monkeypatch.setattr(cls, "BIG_SCENE_CAPACITY", 1)
        monkeypatch.setattr(cls, "WARMUP_FRAMES", 4)
    frac = 0.285  # steady capacity 18,944 of 65,536; 17,933 filtered live at the switch
    jr = jpipe.Renderer(CONFIG, use_pallas_blend=True, steady_frac=frac)
    jr.init_for_scene(table)
    tr = tpipe.Renderer(convert.config_from_jax(CONFIG), device="cpu", steady_frac=frac)
    tr.init_for_scene(convert.table_from_jax(table))
    steady_cap = tr._plan.steady_capacity
    assert steady_cap == jr._plan.steady_capacity
    base = cam.position.copy()
    modes, oks, counts = [], [], []
    for i in range(22):
        cam.set_position(base + np.float32([0.0, 0.0, -0.06 * max(0, i - 4)]))
        j, t = jr.draw(cam), tr.draw(cam)
        what = f"frame {i}"
        assert_image_close(t.image, j.image, what)
        assert bool(t.ok) == bool(j.ok), what
        assert int(t.num_elements) == int(j.num_elements), what
        assert tr._plan.mode == jr._plan.mode, what
        assert tr._plan.steady_declined == jr._plan.steady_declined, what
        assert_state_equal(tr._plan.state, jr._plan.state, what)
        modes.append(tr._plan.mode)
        oks.append(bool(t.ok))
        counts.append(int(t.num_elements))
    first_steady = modes.index("steady")
    reverted = modes.index("full", first_steady)
    assert max(counts[first_steady:reverted]) >= steady_cap  # an overflow
    assert not any(oks[reverted - 8:reverted])  # those frames were flagged
    assert tr._plan.steady_declined  # the re-probe after the revert declined


def test_renderer_monolithic_temporal_matches_jax():
    """Below BIG_SCENE_CAPACITY: render_frame_temporal with per-tile caps
    (no prefilter), against JAX's Renderer(use_pallas_blend=True)."""
    cfg = dataclasses.replace(CONFIG, blend_depth_cap=8, blend_cap_max=64,
                              packed_slack_per_tile=256)
    table, cam, _jargs, _targs = _inputs(n_front=600, n_back=300)
    jr = jpipe.Renderer(cfg, use_pallas_blend=True)
    jr.init_for_scene(table)
    tr = tpipe.Renderer(convert.config_from_jax(cfg), device="cpu")
    tr.init_for_scene(convert.table_from_jax(table))
    assert tr._plan is None and tr.temporal_caps
    launches = tbk.FLAT_LAUNCHES
    for i in range(3):
        j, t = jr.draw(cam), tr.draw(cam)
        assert_image_close(t.image, j.image, f"monolithic frame {i}")
        assert bool(t.ok) == bool(j.ok)
        assert_state_equal(tr._caps, jr._caps, f"monolithic frame {i}")
    assert tbk.FLAT_LAUNCHES == launches  # CPU tensors: plain version


def test_capped_port_renders_without_jax():
    script = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["vk3dgaussiansplatting_tpu"] = None
        import torch
        torch.set_num_threads(1)
        from vk3dgaussiansplatting_tpu_torch import Renderer, RenderConfig
        from vk3dgaussiansplatting_tpu_torch.scenes import synthetic
        cfg = RenderConfig(width=64, height=48, capacity_slack_per_tile=16,
                           blend_depth_cap=384, blend_cap_max=4096)
        scene = synthetic.SimpleTestGaussiansScene(aspect=cfg.aspect)
        scene.init()
        r = Renderer(cfg, device="cpu")
        r.BIG_SCENE_CAPACITY = 1  # the chained plan and its prefilter
        r.WARMUP_FRAMES = 2
        r.init_for_scene(scene.gaussians())
        for _ in range(4):
            out = r.draw(scene.camera)
        assert r._plan.mode == "steady" and bool(out.ok)
        assert out.image_u8[..., :3].any()
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                       for m, v in sys.modules.items() if v is not None)
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_new_wrappers_reject_bad_inputs():
    cfg = RenderConfig(width=64, height=48)
    frame = GaussianFrameData(color_alpha=torch.zeros((4, 4)), cov2d=torch.zeros((4, 3)),
                              cov_inv=torch.zeros((4, 3)), screen_pos=torch.zeros((4, 2)))
    index = torch.zeros(8, dtype=torch.int64)
    ranges = torch.zeros((cfg.num_tiles, 2), dtype=torch.int64)
    for bad in ((frame._replace(screen_pos=frame.screen_pos[:, :1]), index, ranges),
                (frame._replace(color_alpha=frame.color_alpha.double()), index, ranges),
                (frame, index.to(torch.int32), ranges), (frame, index, ranges[:-1]),
                (frame, index, ranges.to(torch.int32))):
        with pytest.raises(ValueError):
            tbk.blend_flat(*bad, cfg, with_t=True)
    with pytest.raises(ValueError):
        tbk.blend_flat(frame, index, ranges, cfg, cap=-1)
    with pytest.raises(ValueError):
        tbk.blend_flat(frame, index, ranges, RenderConfig(width=64, height=48,
                                                          blend_batch_k=100))
    cum = torch.tensor([2, 2, 5], dtype=torch.int64)
    with pytest.raises(ValueError):
        expand_kernel.expand_rows_streamed(torch.zeros((2, 3), dtype=torch.int64), cum, 8)
    with pytest.raises(ValueError):
        expand_kernel.expand_rows_streamed(torch.zeros((2, 4), dtype=torch.int32), cum, 8)
    with pytest.raises(ValueError):
        expand_kernel.expand_rows_streamed(torch.zeros((2, 3), dtype=torch.int32),
                                           cum.float(), 8)
