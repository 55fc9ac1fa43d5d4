"""The readings a cell's limits are set from, on the card.

    python3 gpu_bench/calibrate.py --workload poisson2d_4096.spmv \
        --seeds 11,12,13 --seconds 2
    python3 gpu_bench/calibrate.py --workload poisson2d_4096.spmv \
        --seeds 11,12,13 --seconds 2 --control reference_bf16

Without ``--control``, the lower readings, in one process: the
configuration's matrix and plan are built once (every configuration here
draws its matrix independently of the seed), then for each seed the
cell's inputs, a short window at the cell's own load, and every number
the run compares, for each output it kept (``readings``).

With ``--control``, the upper readings: for each seed one whole run of
the cell (``bench.run_cell``) with that control of the mix's kind
(``kinds/<kind>.py:CONTROLS``) put in the program's place, through the
cell's own comparison; its ``correct`` has to come out false.

One JSON line a seed goes to standard output and to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gpu_bench.harness import bench  # noqa: E402
from gpu_bench.harness.traffic import (make_plan, plan_dtype,  # noqa: E402
                                       sample)


def window(kind, seed, seconds):
    per_call = kind.warm_up()
    return kind.window(seconds, sample(seed, int(seconds / per_call),
                                       kind.mix["samples"]))


def counted(counters: dict) -> dict:
    """The distinct values of each whole-number counter of a window."""
    return {k: sorted({int(x) for x in v}) for k, v in counters.items()
            if isinstance(v, list)}


def lower(spec, seeds, seconds, device):
    A, info = spec.config_module.build(spec.config, seeds[0], device)
    plan = make_plan(A, device, {}, plan_dtype(spec.mix))
    for seed in seeds:
        kind = spec.kind.Kind(spec.mix, A, info, seed, device, {}, plan=plan)
        w = window(kind, seed, seconds)
        yield {"seed": seed, "calls": w.calls, "strategy": plan.strategy,
               **counted(w.counters), **kind.readings(w.kept)}
        del kind, w


def upper(name, seeds, seconds, device, control):
    for seed in seeds:
        line = bench.run_cell(name, seed, seconds, False, device,
                              time.perf_counter(), control=control)
        yield {"seed": seed, "control": control, "correct": line["correct"],
               "failed": line["failed"], "attempted": line["attempted"],
               "checks": line["checks"]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control")
    p.add_argument("--out")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    spec = bench.load_cell(args.workload)
    device = torch.device("cuda")
    lines = (upper(args.workload, seeds, args.seconds, device, args.control)
             if args.control else lower(spec, seeds, args.seconds, device))
    for line in lines:
        line = {"workload": args.workload, **line}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
