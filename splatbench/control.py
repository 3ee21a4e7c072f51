"""The readings the limits of a cell's check are set from, in one process
on the card (never run by the benchmark's own runs):

    python3 -m splatbench.control --workload garden-orbit --seeds 1 2 3 \\
        --control-seeds 1 2 3 --seconds 3

  program  a run of the cell per seed (run.run_cell, a `--seconds` window),
           its numbers compared: the lower readings;
  control  the reference in bfloat16, the precision below the
           configuration's float32, put in the program's place: at the
           poses of the frames a run keeps, against the float32 reference,
           per seed: the upper readings.

One JSON line per reading, then one with the largest program reading and
the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import judge, run, spec


def control_readings(cell: spec.Cell, seed: int, frames: list[int], device="cuda") -> dict:
    """The worst numbers of the bfloat16 reference against the float32 one
    over the poses of window frames `frames` of `seed`'s scene."""
    import torch

    from . import reference

    cloud, orbit, fr, _mult, _live = run.make_scene(cell, seed, torch.device(device))
    readings = []
    for i in frames:
        cam = orbit.camera(cell.traffic["warmup_frames"] + i)
        view, proj = cam.matrices()
        want = reference.render(cloud, view, proj, cam.position, fr)[0]
        low = reference.render(cloud, view, proj, cam.position, fr, torch.bfloat16)[0]
        readings.append(judge.compare(low, want))
    return judge.worst(readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    # The poses of the frames a run keeps, and of one as far in as a
    # garden window's last.
    frames = sorted(set(cell.traffic["kept_frames"]) | {2000})
    program, control = [], []
    for seed in args.seeds:
        result, checks = run.run_cell(cell, seed, args.seconds, False, t0=time.perf_counter())
        got = {k: c["value"] for k, c in checks.items()}
        program.append(got)
        print(json.dumps({"cell": cell.name, "side": "program", "seed": seed, **got,
                          "attempted": result["attempted"], "failed": result["failed"],
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()}}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        got = control_readings(cell, seed, frames)
        control.append(got)
        print(json.dumps({"cell": cell.name, "side": "control", "seed": seed, **got}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"cell": cell.name, "side": "summary"}
    for k in judge.NUMBERS:
        if program:
            summary[f"{k}_lower"] = max(r[k] for r in program)
        if control:
            summary[f"{k}_upper"] = min(r[k] for r in control)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
