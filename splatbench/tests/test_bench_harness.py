"""The harness driven by data: a cell added as files and BENCHMARK.json
entries runs with no edit to an existing file, a bitonic one at a power of
two capacity too; its result line has the contract's keys; a render
setting the reference cannot judge is refused before the run; a run
without a CUDA card fails and prints no result; and a run with the timed
path broken underneath comes out not correct."""

import json
import subprocess
import sys

import pytest
import torch

from splatbench import run, spec
from splatbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.write_root(tmp_path_factory.mktemp("bench"), {
        "tiny-orbit": ("tiny-move", tiny.traffic(0.05)),
        "tiny-capped": ("tiny-capped-move", tiny.traffic(0.05, cap=384)),
    })


def _run(root, name, trace=False, seed=2**31 + 11, device="cpu"):
    cell = spec.load_cell(name, root)
    result, checks = run.run_cell(cell, seed, 0.5, trace, device)
    return dict(result, checks=checks)


@pytest.mark.parametrize("name", ["tiny-orbit", "tiny-capped"])
def test_an_added_cell_runs_and_is_correct(root, name):
    line = _run(root, name)
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == {"off1_share", "max_step"}
    json.dumps(line)


def test_a_bitonic_cell_at_a_power_of_two_capacity_runs_and_is_correct(tmp_path):
    """The reference renderer's other sort tier over its own capacity,
    ceilPow2(N + slack * tiles), added as files and entries alone."""
    cfg = tiny.tiny_config()
    cfg = dict(cfg, capacity=131072,
               render=dict(cfg["render"], sort_algorithm="bitonic", capacity_pow_two=True))
    root = tiny.write_root(tmp_path, {"tiny-bitonic-orbit": ("tiny-move", tiny.traffic(0.05))},
                           config=cfg)
    line = _run(root, "tiny-bitonic-orbit")
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


def _no_scene(*args):
    raise AssertionError("the scene was made")


def _unknown_key(cfg, traffic, monkeypatch):
    traffic["render"]["blend_depth_kap"] = 384
    return "blend_depth_kap"


def _unmodelled_off_default(cfg, traffic, monkeypatch):
    from splatbench import reference

    monkeypatch.setattr(reference, "IMAGE_NEUTRAL", reference.IMAGE_NEUTRAL - {"blend_batch_k"})
    traffic["render"]["blend_batch_k"] = 512
    return "blend_batch_k"


def _modelled_left_to_default(cfg, traffic, monkeypatch):
    del cfg["render"]["sh_mode"]
    return "sh_mode"


@pytest.mark.parametrize("case", [_unknown_key, _unmodelled_off_default,
                                  _modelled_left_to_default],
                         ids=["unknown-key", "unmodelled-off-default", "modelled-left-to-default"])
def test_a_render_setting_the_reference_cannot_judge_is_refused(tmp_path, monkeypatch, case):
    """Refused, naming the key, before the scene is made."""
    cfg, traffic = tiny.tiny_config(), tiny.traffic(0.05)
    key = case(cfg, traffic, monkeypatch)
    root = tiny.write_root(tmp_path, {"tiny-refused": ("tiny-odd", traffic)}, config=cfg)
    monkeypatch.setattr(run, "make_scene", _no_scene)
    with pytest.raises(ValueError, match=repr(key)):
        _run(root, "tiny-refused")


def test_an_unmodelled_setting_at_its_default_is_taken(tmp_path, monkeypatch):
    from splatbench import reference

    monkeypatch.setattr(reference, "IMAGE_NEUTRAL", reference.IMAGE_NEUTRAL - {"blend_batch_k"})
    traffic = tiny.traffic(0.05)
    traffic["render"]["blend_batch_k"] = 768
    root = tiny.write_root(tmp_path, {"tiny-default": ("tiny-plain", traffic)})
    assert run.render_settings(spec.load_cell("tiny-default", root))["blend_batch_k"] == 768


def test_the_first_frame_on_the_patch_path_is_compared(tmp_path, capsys):
    """A camera step wide enough that the capped blend patches its frames:
    the window's first patched frame is kept and judged with the others."""
    root = tiny.write_root(tmp_path, {"tiny-capped-fast": ("tiny-capped-jump",
                                                           tiny.traffic(0.5, cap=384))})
    line = _run(root, "tiny-capped-fast")
    assert line["correct"] is True, line["checks"]
    err = capsys.readouterr().err
    assert "first frames on the patch and full paths {'patch': 0}" in err, err


def test_a_traced_run_on_the_cpu_reports_no_device_metric(root):
    line = _run(root, "tiny-capped", trace=True)
    assert set(line) == KEYS and line["correct"] is True
    assert line["metrics"] == {}


def test_a_traced_run_on_the_cpu_traces_the_host(root, capsys):
    """The host-only tracer's loop runs on the CPU too (4 x trace_frames
    frames, no sync on the uncapped path); the profiled slices need a card
    and are skipped, and the run still comes out correct."""
    line = _run(root, "tiny-orbit", trace=True)
    assert line["correct"] is True and line["metrics"] == {}
    err = capsys.readouterr().err
    assert "host: 8 frames under the host-only tracer, host_frame_ms " in err, err
    assert "0 syncs a frame" in err and "profiled slice" not in err


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "splatbench.run", "--workload", "garden-orbit",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _stale(monkeypatch):
    from vk3dgaussiansplatting_tpu_torch import Renderer

    real, first = Renderer.draw, {}

    def draw(self, camera, timer=None):
        out = real(self, camera, timer)
        return first.setdefault("out", out)

    monkeypatch.setattr(Renderer, "draw", draw)


def _half(monkeypatch):
    from vk3dgaussiansplatting_tpu_torch import Renderer

    real = Renderer.init_for_scene

    def init(self, table):
        real(self, table.take(torch.arange(0, table.num_gaussians, 2)))

    monkeypatch.setattr(Renderer, "init_for_scene", init)


def _altered(monkeypatch):
    from vk3dgaussiansplatting_tpu_torch.ops import blend

    real = blend.quantize_image

    def quantize(img):
        out = real(img).clone()
        out[40:56, 80:96, 1] ^= 0x40
        return out

    monkeypatch.setattr(blend, "quantize_image", quantize)


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state-unchanged", "half-left-out", "answer-altered"])
@pytest.mark.parametrize("name", ["tiny-orbit", "tiny-capped"])
def test_a_broken_timed_path_comes_out_not_correct(root, name, fault, monkeypatch):
    """Each fault a single-card renderer can have (no cell crosses chips,
    so there is no exchange to leave out)."""
    fault(monkeypatch)
    line = _run(root, name)
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
def test_an_added_cell_runs_on_the_card(root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = _run(root, "tiny-orbit", trace=True, device="cuda")
    assert line["correct"] is True, line["checks"]
    assert {"device_idle_pct", "frame_mfu", "keygen_ms", "sort_roofline_pct"} <= set(line["metrics"])
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
