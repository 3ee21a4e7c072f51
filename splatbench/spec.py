"""Finds a cell's files by the names in BENCHMARK.json.

A cell (`workloads` entry) names a configuration and a traffic mix:

  * the configuration's file is the `file` of its `configs` entry
    (`splatbench/configs/<name>.json`): the scene's sizes, the render
    constants as the port's RenderConfig takes them, and what was assumed;
  * the traffic is `splatbench/workloads/<traffic>.json`: the camera loop,
    the render settings the mix adds (the depth cap), the warm-up and the
    frames the check keeps;
  * the limits of the numbers the check compares are
    `splatbench/limits/<cell>.json`.

Adding a cell is adding those files and entries; nothing here names one.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list  # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    bench_dir = root / Path(cfg["file"]).parent.parent
    return Cell(
        name=name,
        chips=w["chips"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((bench_dir / "workloads" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench_dir / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
