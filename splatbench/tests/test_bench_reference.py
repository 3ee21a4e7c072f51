"""The reference renderer against the port's CPU path (the plain versions
of its kernels) at a tiny size: the same live elements, the same image to
rounding, in each SH mode; the bfloat16 control far from both; the
capacity as the reference renderer rounds it; and every RenderConfig field
either modelled by the reference or known to leave the frame as it is."""

import dataclasses
import json

import pytest
import torch

from splatbench import judge, reference, scene
from splatbench.tests import tiny


def _frames(cap: int, sh_mode: int = 0):
    from vk3dgaussiansplatting_tpu_torch import (Renderer, RenderConfig, SortAlgorithm,
                                                 SphericalHarmonicsMode)
    from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable

    cfg = tiny.tiny_config()
    render = dict(cfg["render"], sh_mode=sh_mode)
    fr = reference.frame_constants(render, cfg["gaussians"])
    rc = RenderConfig(**dict(render, blend_depth_cap=cap,
                             sh_mode=SphericalHarmonicsMode(sh_mode),
                             sort_algorithm=SortAlgorithm(render["sort_algorithm"])))
    cloud = scene.make_cloud(cfg["gaussians"], cfg["assumed"]["cloud"], 2**31 + 7, "cpu")
    orbit = scene.Orbit(cfg["assumed"]["camera"], rc.width / rc.height, 16, 0.02, 5)
    mult, _ = scene.calibrate(cloud, orbit.centre(), fr, cfg["target_live"], 0.001)
    cloud = scene.scaled(cloud, mult)
    r = Renderer(rc, device="cpu")
    r.init_for_scene(GaussianTable(*cloud))
    for i in range(3):
        cam = orbit.camera(i)
        out = r.draw(cam)
        view, proj = cam.matrices()
        yield out, reference.render(cloud, view, proj, cam.position, fr), (cloud, cam, fr)


@pytest.mark.parametrize("cap", [0, 384], ids=["uncapped", "capped"])
def test_reference_matches_the_ports_cpu_path(cap):
    torch.set_num_threads(2)
    for out, (img, _p, s, _rows), _ in _frames(cap):
        assert int(out.num_elements) == s.live
        got = judge.compare(out.image_u8, img)
        assert got["max_step"] <= 1, got
        assert out.ok is None or bool(out.ok)


@pytest.mark.parametrize("sh_mode", [0, 1, 2],
                         ids=["all-bands", "skip-first-band", "only-first-band"])
def test_reference_follows_each_sh_mode(sh_mode):
    """The port's CPU path in each of getShColor's modes against the
    reference in that mode; every mode but ALL_BANDS gives another image
    than ALL_BANDS, so a reference that ignored the mode would fail."""
    torch.set_num_threads(2)
    for out, (img, _p, s, _rows), (cloud, cam, fr) in _frames(0, sh_mode):
        assert fr.sh_mode == sh_mode
        assert int(out.num_elements) == s.live
        got = judge.compare(out.image_u8, img)
        assert got["max_step"] <= 1, got
        if sh_mode:
            view, proj = cam.matrices()
            all_bands, *_ = reference.render(cloud, view, proj, cam.position,
                                             fr._replace(sh_mode=reference.ALL_BANDS))
            assert judge.compare(out.image_u8, all_bands)["max_step"] > 1


def test_the_capacity_is_the_reference_renderers():
    """N + slack * tiles, rounded up to a power of two where
    `capacity_pow_two` (ceilPow2, Renderer.cpp:725), the rounding as the
    port's."""
    from vk3dgaussiansplatting_tpu_torch.core.config import ceil_pow_two

    cfg = json.loads(tiny.REPO_CONFIG.read_text())
    n, render = cfg["gaussians"], cfg["render"]
    assert reference.frame_constants(dict(render, capacity_pow_two=False), n).capacity == 14190624
    assert reference.frame_constants(dict(render, capacity_pow_two=True), n).capacity == 16777216
    for x in (1, 2, 3, 77728, 2**24, 2**24 + 1):
        assert reference.ceil_pow_two(x) == ceil_pow_two(x)


def test_every_render_field_is_modelled_or_image_neutral():
    """A field RenderConfig gains fails here until it is put in one set."""
    from vk3dgaussiansplatting_tpu_torch import RenderConfig

    names = {f.name for f in dataclasses.fields(RenderConfig)}
    assert not reference.MODELLED & reference.IMAGE_NEUTRAL
    assert reference.MODELLED | reference.IMAGE_NEUTRAL == names


def test_bfloat16_control_is_far_from_the_reference():
    torch.set_num_threads(2)
    out, (img, *_), (cloud, cam, fr) = next(_frames(0))
    view, proj = cam.matrices()
    low, *_ = reference.render(cloud, view, proj, cam.position, fr, torch.bfloat16)
    got = judge.compare(low, img)
    assert got["off1_share"] > 0.1, got


def test_ranges_keep_the_reference_quirk_at_a_full_list():
    fr = reference.Frame(32, 16, 16, 0.1, 100.0, 1.5, 1.3, 0.8, 0.3, 1 / 255, 1e-4, capacity=5)
    tile = torch.tensor([0, 0, 1, 1, 1])
    assert reference.find_ranges(tile, fr).tolist() == [[0, 2], [2, 4]]
    tile = torch.tensor([0, 0, 0, 0, 1])
    assert reference.find_ranges(tile, fr).tolist() == [[0, 0], [0, 4]]
    short = fr._replace(capacity=6)
    assert reference.find_ranges(tile, short).tolist() == [[0, 4], [4, 5]]
