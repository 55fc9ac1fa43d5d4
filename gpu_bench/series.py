"""Run one cell several times, one process a run and one after another,
and summarise the spread of each metric.

    python3 gpu_bench/series.py --workload poisson2d_4096.spmv \
        --seeds 101,102,103,104,105,106 --seconds 20 --trace 0 \
        --out series.jsonl

Each run is ``gpu_bench/run.py`` as the benchmark's command gives it.  Its
result line (or its exit code and the end of its standard error) goes to
``--out``; the summary gives, for each metric, the values, the median and
the spread: the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median, and the
bound five times that spread would give.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    """The interquartile distance over the median."""
    if len(values) < 2:
        return 0.0
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "gpu_bench" / "run.py"),
             "--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t
        line = {"workload": args.workload, "seed": seed, "rc": proc.returncode,
                "wall_s": wall, "card": card()}
        try:
            line["result"] = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            line["stderr"] = proc.stderr[-4000:]
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        res = line.get("result", {})
        print(f"seed {seed} rc {proc.returncode} wall {wall:.1f}s correct "
              f"{res.get('correct')} checks {res.get('checks')} "
              f"peak {res.get('device', {}).get('memory_peak_bytes')}",
              flush=True)
        for name, m in res.get("metrics", {}).items():
            values.setdefault(name, []).append(m["value"])
    for name, vals in values.items():
        s = spread(vals)
        print(f"{name}: median {statistics.median(vals)!r} spread {s:.5f} "
              f"(5x {5 * s:.5f}) values {vals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
