"""Run one cell of the benchmark once and print its result line.

    python3 gpu_bench/run.py --workload poisson2d_4096.spmv --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout.  The run builds its inputs from ``--seed``,
plans and warms up (set-up), measures for ``--seconds``, checks what the
timed path produced against the float64 reference, and prints one JSON
object as the last line of standard output: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics (and the trace's
``breakdown``) with ``--trace 1``.  Each number compared is printed
beside its limit as the last lines of standard error and under
``checks``, the line's last key.  Without a CUDA card the run exits with
code 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own nvcc build lives in build/tpu_spmv_torch/)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, device="cuda", shrink=None, t0=T0) -> int:
    """The CLI; the CPU tests pass ``device="cpu"`` and a ``shrink`` of the
    configuration (the rehearsal, whose result names the CPU)."""
    args = parse(argv)
    import torch

    from gpu_bench.harness import bench

    chips = bench.load_cell(args.workload).cell["chips"]
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"gpu_bench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = bench.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device, t0, shrink)
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"gpu_bench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
