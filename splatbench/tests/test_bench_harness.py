"""The harness driven by data: a cell added as files and BENCHMARK.json
entries runs with no edit to an existing file; its result line has the
contract's keys; a run without a CUDA card fails and prints no result;
and a run with the timed path broken underneath comes out not correct."""

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
