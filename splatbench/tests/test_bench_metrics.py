"""The per-layer readers on hand-built readings: the host's and keygen's
parts read what the traced run gives them and nothing without it, and a
`Readings` built without the host's fields still serves every reader; and
BENCHMARK.json's per-layer entries name a reader, known cells and an
end-to-end metric those cells report."""

import json

import pytest

from splatbench import metrics, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW = ["host_frame_ms", "idle_host_paced_pct", "depth_order_ms", "expand_ms"]


def readings(**kw):
    """Four frames of the radix path's sections, a 48-frame slice, and the
    host's readings: 1.5 ms a frame in `frame` spans, 30 us of 0.15 s idle
    inside the port."""
    base = dict(frames=4, sections={"keygen": 6.0, "depth_order": 1.8, "expand": 1.0,
                                    "sort": 2.4},
                path_counts={}, live_mean=13.0e6, work=None, slice_frames=48, busy_s=0.146,
                window_s=0.15, host_spans={"frames": 192, "host_frame_ms": 1.5},
                host_idle={"idle_us": 4000.0, "in_port_us": 30.0, "in_sync_us": 0.0,
                           "outside_us": 3970.0},
                host_slice_s=0.15)
    base.update(kw)
    return metrics.Readings(**base)


@pytest.mark.parametrize("name,value", [("host_frame_ms", 1.5), ("idle_host_paced_pct", 0.02),
                                        ("depth_order_ms", 0.45), ("expand_ms", 0.25)])
def test_a_new_reader_reads_its_part(name, value):
    assert metrics.load(name)(readings()) == pytest.approx(value)


@pytest.mark.parametrize("name,missing", [
    ("host_frame_ms", {"host_spans": None}),
    ("host_frame_ms", {"host_spans": {}}),  # span_summary of a loop with no frame
    ("idle_host_paced_pct", {"host_idle": None}),
    ("idle_host_paced_pct", {"host_slice_s": None}),
    ("idle_host_paced_pct", {"host_slice_s": 0.0}),
    ("depth_order_ms", {"sections": {"keygen": 6.0, "expand": 1.0, "sort": 2.4}}),
    ("expand_ms", {"sections": {}}),
    ("expand_ms", {"frames": 0}),
])
def test_a_new_reader_without_its_inputs_gives_none(name, missing):
    assert metrics.load(name)(readings(**missing)) is None


def test_readings_without_the_host_fields_serve_every_reader():
    """The eight fields a `Readings` had before the host's, positionally:
    the host's readers give None, the others read as before."""
    r = metrics.Readings(4, {"keygen": 6.0, "expand": 1.0}, {}, 13.0e6, None, 48, 0.146, 0.15)
    assert (r.host_spans, r.host_idle, r.host_slice_s) == (None, None, None)
    assert metrics.load("host_frame_ms")(r) is None
    assert metrics.load("idle_host_paced_pct")(r) is None
    assert metrics.load("expand_ms")(r) == 0.25
    assert metrics.load("keygen_ms")(r) == 1.5
    assert metrics.load("device_idle_pct")(r) == pytest.approx(100 * (1 - 0.146 / 0.15))
    for m in BENCH["per_layer"]:
        metrics.load(m["name"])(r)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_lists_the_new_metrics_its_path_has(cell):
    c = spec.load_cell(cell)
    names = {m["name"] for m in c.per_layer}
    has_depth_order = c.config["render"]["sort_algorithm"] != "bitonic"
    assert {"host_frame_ms", "idle_host_paced_pct", "expand_ms"} <= names
    assert ("depth_order_ms" in names) == has_depth_order


def test_every_per_layer_entry_has_a_reader_and_known_cells():
    by = {m["name"]: m for m in BENCH["per_layer"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert all(name in by and by[name]["workloads"] for name in NEW)
    assert "garden-bitonic-orbit" not in by["depth_order_ms"]["workloads"]
    for m in BENCH["per_layer"]:
        assert (metrics.HERE / f"{m['name']}.py").is_file(), m["name"]
        assert set(m["workloads"]) <= set(CELLS), m["name"]
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", CELLS)), m["name"]
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert layers[by["host_frame_ms"]["layer"]] == {"host_frame_ms", "idle_host_paced_pct"}
    assert layers[by["keygen_ms"]["layer"]] == {"keygen_ms", "keygen_roofline_pct"}
    assert layers[by["bitonic_shared_ms"]["layer"]] == {"bitonic_shared_ms", "bitonic_global_ms",
                                                        "bitonic_roofline_pct"}
