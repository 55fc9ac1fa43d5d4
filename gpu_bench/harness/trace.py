"""The traced window: ``torch.profiler`` over a short run of the cell's
own calls, reduced to device busy time, idle gaps and the device ops that
took the most time.

Every device op counts, whatever its name (kernels, copies, fills), so no
metric depends on what a kernel is called.  Busy time is the union of
the ops' intervals inside the window, which is the span of a
``record_function`` marker around the calls in the trace's own clock.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
MARK = "gpu_bench.window"
TOP = 10
NAME_CHARS = 120


@dataclass
class TraceSummary:
    calls: int
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def profile(loop, path: Path) -> TraceSummary | None:
    """Run ``loop()`` (which returns its call count, synchronised) under
    the profiler, write the trace to ``path`` (gzipped chrome trace, the
    run's last one kept) and reduce it; ``None`` where the trace holds no
    device op (no card, or no CUPTI)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(MARK):
            calls = loop()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    return reduce_events(events, calls)


def _union(intervals):
    """Merged, sorted ``[start, end]`` intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events: list, calls: int) -> TraceSummary | None:
    """Busy time, the top device ops and the longest idle gaps (named by
    the innermost host op running across the gap) of a chrome trace,
    times in microseconds."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    mark = [e for e in xs if e.get("name") == MARK
            and e.get("cat") == "user_annotation"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not mark or not dev:
        return None
    w0 = float(mark[0]["ts"])
    w1 = w0 + float(mark[0]["dur"])
    spans, by_name = [], {}
    for e in dev:
        s, t = max(float(e["ts"]), w0), min(float(e["ts"]) + e["dur"], w1)
        if t > s:
            spans.append((s, t))
            name = e["name"][:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
    busy = _union(spans)
    if not busy:
        return None
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    host = [e for e in xs if e.get("cat") in HOST_CATS
            and e.get("name") != MARK]
    named_gaps = []
    for length, start in gaps:
        mid = start + length / 2
        around = [e for e in host
                  if e["ts"] <= mid <= e["ts"] + e["dur"]]
        inner = min(around, key=lambda e: e["dur"], default=None)
        label = inner["name"][:NAME_CHARS] if inner else "none"
        named_gaps.append([f"host: {label}", length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    return TraceSummary(
        calls=calls, window_s=(w1 - w0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        device_ops=[[k, v] for k, v in ops], idle_gaps=named_gaps)
