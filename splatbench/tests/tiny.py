"""A tiny benchmark root for the tests: a BENCHMARK.json of one tiny
configuration and its cells, with their configuration, traffic and limits
files, written the way a later change adds a cell."""

from __future__ import annotations

import json
from pathlib import Path

from splatbench import spec

REPO_CONFIG = spec.HERE / "configs" / "garden30k_1080p.json"
TINY = {"gaussians": 4000, "width": 192, "height": 96, "target_live": 20000}


def tiny_config() -> dict:
    cfg = json.loads(REPO_CONFIG.read_text())
    render = dict(cfg["render"], width=TINY["width"], height=TINY["height"])
    tiles = -(-TINY["width"] // 16) * -(-TINY["height"] // 16)
    return dict(cfg, name="tiny", gaussians=TINY["gaussians"], target_live=TINY["target_live"],
                capacity=TINY["gaussians"] + render["capacity_slack_per_tile"] * tiles,
                render=render)


def traffic(step: float, cap: int = 0) -> dict:
    render = {"blend_depth_cap": cap, "blend_cap_max": 4096} if cap else {"blend_depth_cap": 0}
    return {"camera": {"poses": 16, "step": step}, "render": render, "steady_frac": 0.51,
            "frames_in_flight": 3, "warmup_frames": 2, "kept_frames": [0, 1], "trace_frames": 2}


LIMITS = {"off1_share": 0.001, "max_step": 8}


def write_root(root: Path, cells: dict[str, tuple[str, dict]], config: dict | None = None) -> Path:
    """`root`/BENCHMARK.json and splatbench/{configs,workloads,limits}
    files for `cells` {name: (traffic name, traffic)} on the tiny
    configuration, or on `config` in its place."""
    base = root / "splatbench"
    for sub in ("configs", "workloads", "limits"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    (base / "configs" / "tiny.json").write_text(json.dumps(config or tiny_config()))
    workloads = []
    for name, (tname, t) in cells.items():
        (base / "workloads" / f"{tname}.json").write_text(json.dumps(t))
        (base / "limits" / f"{name}.json").write_text(json.dumps(LIMITS))
        workloads.append({"name": name, "config": "tiny", "traffic": tname, "chips": 1,
                          "why": "a test cell"})
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "a test", "file": "splatbench/configs/tiny.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = workloads
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
