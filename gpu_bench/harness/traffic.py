"""The general traffic generator: one closed loop, one stream.

A mix is a data file, ``traffic/<mix>.json``; the ``kind`` it names is
the module ``kinds/<kind>.py`` that makes its calls (see
``kinds/__init__.py``).  What every kind shares lives here: the streams
of draws from ``--seed``, the closed loop that runs a window, the calls
kept for the check, and ``plan_spmv`` as a user calls it.
"""

from __future__ import annotations

import hashlib
import random
import time
from dataclasses import dataclass, field

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one named stream of draws from ``--seed``."""
    digest = hashlib.sha256(":".join(map(str, (seed,) + tags)).encode())
    return int.from_bytes(digest.digest()[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device).manual_seed(derive(seed, *tags))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """One window's calls: their count and seconds, the wall time of each
    where timed, the outputs kept, and what the kind counted or timed in
    it (``counters``, ``spans``), which the metrics' readers read."""

    calls: int = 0
    seconds: float = 0.0
    durations: list = field(default_factory=list)   # per call, if timed
    kept: dict = field(default_factory=dict)        # call index -> output
    counters: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)


def closed_loop(step, seconds: float, device, *, keep=(), timed=False
                ) -> Window:
    """Call ``step(i)`` back to back until ``seconds`` have passed, then
    synchronise.  ``timed`` synchronises after every call and records its
    wall time; the outputs of the calls in ``keep`` and of the last are
    kept."""
    w = Window()
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        out = step(w.calls)
        if timed:
            sync(device)
            w.durations.append(time.perf_counter() - t)
        if w.calls in keep:
            w.kept[w.calls] = out
        w.calls += 1
        if time.perf_counter() - start >= seconds:
            break
    sync(device)
    w.seconds = time.perf_counter() - start
    w.kept[w.calls - 1] = out
    return w


def sample(seed: int, expected: int, count: int) -> set:
    """``count`` call indices drawn from the seed among the ``expected``
    calls of a window (those past its end are never reached)."""
    rng = random.Random(derive(seed, "sample"))
    return set(rng.sample(range(max(expected, count)), count))


def plan_dtype(mix: dict) -> torch.dtype:
    """The value type a mix plans its matrix in (``dtype``, by default
    float32)."""
    return getattr(torch, mix.get("dtype", "float32"))


def make_plan(A, device, spans: dict, dtype=torch.float32):
    """``plan_spmv`` of the configuration's matrix (a host CSR), as a user
    calls it, timed to its last device copy (``spans["plan_s"]``)."""
    import scipy.sparse as sp
    from tpu_spmv_torch.ops.auto import plan_spmv

    mat = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    t = time.perf_counter()
    plan = plan_spmv(mat, dtype=dtype, device=device)
    sync(device)
    spans["plan_s"] = time.perf_counter() - t
    return plan
