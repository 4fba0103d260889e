"""Runs of one cell, one process after another, and their spread.

    python3 benchmark/sets.py --workload <cell> --seconds <s> --seeds 11 12 13 \
        [--sets 2] [--trace-seeds 21 22] [--control-seeds 31 32] [--out chiprun_out/<dir>]

runs ``benchmark/run.py`` once a seed in each of ``--sets`` sets (the same
seeds in every set), then once a trace seed with ``--trace 1``, then
``benchmark/control.py`` once a control seed; keeps each run's output under
``--out``, and prints a summary line a run and, for each end-to-end metric,
each set's median and spread (the distance between the first and the
third quartile of ``statistics.quantiles(values, n=4)``, over the median).
This is the tool for setting bounds and limits; the benchmark's own runs
do not use it."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(script, workload, seed, seconds, trace, out_dir, tag):
    cmd = [sys.executable, os.path.join("benchmark", script), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds)]
    if script == "run.py":
        cmd += ["--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{tag}.out"), "w") as f:
        f.write(p.stdout[-200000:])
    with open(os.path.join(out_dir, f"{tag}.err"), "w") as f:
        f.write(p.stderr[-200000:])
    lines = p.stdout.strip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        res = None
    samples = next((ln for ln in lines if ln.startswith("[samples]")), "")
    print(json.dumps({"tag": tag, "rc": p.returncode, "wall_s": round(wall, 2),
                      "samples": samples, "result": res}), flush=True)
    if res is None:
        sys.stdout.write(p.stderr[-3000:] + "\n")
    return res


def spread(values):
    q = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, (q[2] - q[0]) / med if med else float("nan")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "sets"))
    a = ap.parse_args()
    out_dir = os.path.join(ROOT, a.out)
    os.makedirs(out_dir, exist_ok=True)
    sets = []
    for s in range(a.sets):
        sets.append([one("run.py", a.workload, seed, a.seconds, 0, out_dir, f"set{s}_{seed}")
                     for seed in a.seeds])
    for seed in a.trace_seeds:
        one("run.py", a.workload, seed, a.seconds, 1, out_dir, f"trace_{seed}")
    for seed in a.control_seeds:
        one("control.py", a.workload, seed, a.seconds, 0, out_dir, f"control_{seed}")
    for s, runs in enumerate(sets):
        names = sorted({k for r in runs if r for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in runs if r and name in r["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(json.dumps({"set": s, "metric": name, "median": med, "spread": sp,
                                  "values": vals}), flush=True)


if __name__ == "__main__":
    main()
