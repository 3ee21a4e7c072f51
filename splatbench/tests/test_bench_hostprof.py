"""The host profile (hostprof.py): the idle split and the runtime calls on
synthetic profiler events, the span summary on hand-built spans, and a
profile of the tiny configuration on the CPU (windows and spans)."""

import pytest
import torch

from splatbench import hostprof, spec
from splatbench.tests import tiny
from vk3dgaussiansplatting_tpu_torch.utils.timing import Span

# Two frames on the host's clock (us): frame 0 [0, 100) with a sync at
# [60, 80), frame 1 [120, 200); the harness waits in between.
CPU = [
    ("vk3d/frame", 0.0, 100.0), ("vk3d/policy", 50.0, 90.0), ("vk3d/sync", 60.0, 80.0),
    ("cudaLaunchKernel", 10.0, 12.0), ("cudaStreamSynchronize", 61.0, 79.0),
    ("vk3d/frame", 120.0, 200.0), ("vk3d/keygen", 120.0, 160.0),
    ("cudaMemsetAsync", 130.0, 150.0), ("cudaEventSynchronize", 100.0, 120.0),
]


def test_idle_split_assigns_each_gap_to_what_the_host_was_in():
    gaps = [(5.0, 15.0), (55.0, 85.0), (95.0, 125.0), (300.0, 310.0)]
    split = hostprof.idle_split(gaps, CPU)
    # (5, 15): port 10; (55, 85): port 10 (55-60, 80-85) and sync 20;
    # (95, 125): port 5 + 5, outside 20; (300, 310): outside 10.
    assert split == {"idle_us": 80.0, "in_port_us": 30.0, "in_sync_us": 20.0,
                     "outside_us": 30.0}
    assert hostprof.idle_split([], CPU)["idle_us"] == 0
    assert hostprof.idle_split(gaps, [])["outside_us"] == 80.0


def test_runtime_calls_go_to_the_innermost_port_span():
    calls = hostprof.runtime_calls(CPU)
    assert calls == [["keygen", "cudaMemsetAsync", 20.0],
                     ["(outside the port)", "cudaEventSynchronize", 20.0],
                     ["sync", "cudaStreamSynchronize", 18.0],
                     ["frame", "cudaLaunchKernel", 2.0]]


def test_span_summary_takes_the_syncs_out_of_the_frame():
    ms = 1_000_000
    spans = [Span("sync", 0, "policy", 60 * ms, 80 * ms, 0),
             Span("policy", 0, "frame", 50 * ms, 90 * ms, 20 * ms),
             Span("frame", 0, None, 0, 100 * ms, 40 * ms),
             Span("frame", 1, None, 120 * ms, 200 * ms, 0)]
    out = hostprof.span_summary(spans, {"frame": 2, "sync": 1, "policy": 1, "steady_revert": 1})
    assert out["host_frame_ms"] == (180 - 20) / 2
    assert out["syncs_per_frame"] == 0.5
    assert out["spans_ms"] == {"sync": [10.0, 10.0], "policy": [20.0, 10.0],
                               "frame": [90.0, 70.0]}
    assert out["counts"] == {"steady_revert": 1}
    assert hostprof.span_summary([], {}) == {}


@pytest.mark.parametrize("cap", [0, 384])
def test_a_tiny_profile_on_the_cpu(cap):
    torch.set_num_threads(2)
    cell = spec.Cell("tiny", 1, tiny.tiny_config(), tiny.traffic(0.05, cap=cap), {}, [], [])
    out = hostprof.profile_host(cell, 2**31 + 17, 0.2, 2, device="cpu")
    assert [w["traced"] for w in out["windows"]] == [False, True, True, False]
    spans = out["spans"]
    assert spans["frames"] == sum(w["frames"] for w in out["windows"] if w["traced"])
    assert 0 < spans["host_frame_ms"] <= spans["spans_ms"]["frame"][0]
    assert "slices" not in out and out["device"] == "cpu"
    if cap:
        assert spans["syncs_per_frame"] >= 1 and "policy" in spans["spans_ms"]
    else:
        assert spans["syncs_per_frame"] == 0 and "sync" not in spans["spans_ms"]
    assert hostprof.load("garden30k_1080p", "orbit").traffic["camera"]["step"] == 0.001
