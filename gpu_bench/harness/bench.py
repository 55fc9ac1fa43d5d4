"""One run of one cell, found by name.

``BENCHMARK.json`` names the cell's configuration and traffic mix; the
harness loads ``configs/<config>.json`` and its module
``configs/<config>.py``, the mix ``traffic/<mix>.json`` and the module of
the kind it names, ``kinds/<kind>.py``, the cell's limits
``checks/<cell>.json`` and, for each metric the cell reports, its reader
``metrics/<metric>.py``.  A later cell, configuration, mix, kind or
metric is a new file and a new entry; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from gpu_bench.harness import trace as tracing
from gpu_bench.harness.traffic import Window, sample, sync

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_spmv")


def load_module(path: Path):
    """A module from its file (names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(
        "gpu_bench_file." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules (or ``names``) whose top-level name, compared
    whole, is JAX's or the JAX package's (``tpu_spmv_torch`` is not
    ``tpu_spmv``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Run:
    """What a metric's reader reads: the set-up's seconds and spans, the
    measured window (its calls, seconds, counters and spans), the bytes a
    call moves by the configuration's frozen count and, in a traced run,
    the trace's summary."""

    device: torch.device
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)
    window: Window | None = None
    bytes_per_call: int = 0
    trace: tracing.TraceSummary | None = None

    def peak(self, key: str) -> float | None:
        """A published peak of this card (``peaks.json``), if listed."""
        if self.device.type != "cuda":
            return None
        name = torch.cuda.get_device_name(self.device)
        return read_json(BENCH / "peaks.json").get(name, {}).get(key)


@dataclass
class CellSpec:
    """Everything a cell's name finds: its entry, its configuration (the
    JSON, with any ``shrink`` over it) and module, its mix, the mix's kind
    and the cell's limits (and the control that set each)."""

    bench: dict
    cell: dict
    config: dict
    config_module: object
    mix: dict
    kind: object
    checks: dict

    @property
    def limits(self) -> dict:
        return {k: v["limit"] for k, v in self.checks.items()}


def load_cell(name: str, shrink: dict | None = None) -> CellSpec:
    bench = read_json(ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    centry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mix = read_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return CellSpec(
        bench=bench, cell=cell,
        config={**read_json(ROOT / centry["file"]), **(shrink or {})},
        config_module=load_module(BENCH / "configs" / f"{cell['config']}.py"),
        mix=mix, kind=load_module(BENCH / "kinds" / f"{mix['kind']}.py"),
        checks=read_json(BENCH / "checks" / f"{name}.json"))


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: in the cells it lists,
    or, listing none (``setup_s``), in every cell."""
    return cell in metric.get("workloads", [cell])


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             t0: float, shrink: dict | None = None, control=None) -> dict:
    """One run of cell ``name``: the result line as a dict.  ``shrink``
    overrides configuration keys (a tiny size for the CPU tests);
    ``control`` puts one of the kind's controls in the program's place."""
    spec = load_cell(name, shrink)
    bench, mix, limits = spec.bench, spec.mix, spec.limits
    device = torch.device(device)
    run = Run(device=device)

    A, info = spec.config_module.build(spec.config, seed, device)
    run.bytes_per_call = spec.config_module.bytes_moved(
        spec.config, A, mix.get("nrhs", 1))
    if device.type == "cuda":   # the build's memory is not the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    kind = spec.kind.Kind(mix, A, info, seed, device, run.spans,
                          control=control)
    per_call = kind.warm_up()
    keep = sample(seed, int(seconds / max(per_call, 1e-9)), mix["samples"])
    run.setup_s = (time.perf_counter() - t0
                   - run.spans.get("setup_reference_s", 0.0))

    run.window = kind.window(seconds, keep, traced)
    if traced:
        path = BENCH / "traces" / f"{name}.json.gz"
        traced_s = min(mix["trace_seconds"], seconds)
        run.trace = tracing.profile(
            lambda: kind.window(traced_s, ()).calls, path)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    kind.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, failed = kind.check(run.window, limits)
    sync(device)

    group = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in bench[group]:
        if not applies(m, name):
            continue
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": failed == 0 and all(
                  numbers[k] <= limits[k] for k in numbers),
              "attempted": run.window.calls, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    return result
