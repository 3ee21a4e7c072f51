"""Sets of runs of one cell, for the spreads its bounds are set from:

    python3 -m splatbench.sets --workload garden-orbit --seeds 11 12 13 14 15 16 \\
        --sets 2 --traced 21 22 23 --seconds 10 --out chiprun_out/sets

runs `python3 -m splatbench.run` once per seed in each of `--sets` sets
(the same seeds in every set), then once with `--trace 1` per `--traced`
seed, each run a process of its own, one after another; keeps each run's
stdout and stderr under `--out`; and prints one JSON line per run and a
summary: for each set and end-to-end metric the median and the spread
(the distance between the first and third quartiles of
statistics.quantiles(values, n=4), over the median), and whether every
run was correct.  Never run by the benchmark's own runs."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def spread(values: list[float]) -> float:
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one_run(workload: str, seed: int, seconds: float, trace: int, out: Path, tag: str) -> dict:
    stem = out / f"{workload}.{seed}.{trace}{'.' + tag if tag else ''}"
    cmd = [sys.executable, "-m", "splatbench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    stem.with_suffix(stem.suffix + ".out").write_text(p.stdout)
    stem.with_suffix(stem.suffix + ".err").write_text(p.stderr)
    lines = p.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if p.returncode == 0 and lines else {}
    return {"seed": seed, "trace": trace, "set": tag, "rc": p.returncode,
            "correct": line.get("correct"),
            "metrics": {k: v["value"] for k, v in line.get("metrics", {}).items()},
            "checks": line.get("checks"), "device": line.get("device")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    for k in range(args.sets):
        tag = "AB"[k] if args.sets <= 2 else str(k)
        for seed in args.seeds:
            runs.append(one_run(args.workload, seed, args.seconds, 0, args.out, tag))
            print(json.dumps(runs[-1]), flush=True)
    for seed in args.traced:
        runs.append(one_run(args.workload, seed, args.seconds, 1, args.out, ""))
        print(json.dumps(runs[-1]), flush=True)
    summary = {"workload": args.workload, "side": "summary",
               "all_correct": all(r["correct"] is True for r in runs), "sets": {}}
    for tag in sorted({r["set"] for r in runs if r["trace"] == 0}):
        got = [r for r in runs if r["trace"] == 0 and r["set"] == tag and r["metrics"]]
        names = sorted({n for r in got for n in r["metrics"]})
        summary["sets"][tag] = {
            n: {"median": statistics.median(v), "spread": spread(v) if len(v) > 1 else None}
            for n in names for v in [[r["metrics"][n] for r in got if n in r["metrics"]]]}
    print(json.dumps(summary), flush=True)
    return 0 if summary["all_correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
