"""The reference renderer against the port's CPU path (the plain versions
of its kernels) at a tiny size: the same live elements, the same image to
rounding; and the bfloat16 control far from both."""

import pytest
import torch

from splatbench import judge, reference, scene
from splatbench.tests import tiny


def _frames(cap: int):
    from vk3dgaussiansplatting_tpu_torch import Renderer, RenderConfig
    from vk3dgaussiansplatting_tpu_torch.models.gaussians import GaussianTable

    cfg = tiny.tiny_config()
    fr = reference.frame_constants(cfg["render"], cfg["gaussians"])
    kw = {k: v for k, v in cfg["render"].items() if k not in ("sh_mode", "sort_algorithm")}
    rc = RenderConfig(**dict(kw, blend_depth_cap=cap))
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
