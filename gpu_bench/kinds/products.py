"""``plan(x)`` (``nrhs`` 1) or ``plan.spmm(X)`` back to back, cycling over
``vectors`` seeded float32 operands made on the device, the plan made by
``plan_spmv`` in the mix's ``dtype`` (float32 by default).

Each kept output is compared entry by entry with the float64 reference
of its operand: ``y_err`` is the largest ``|y - y_ref| / (|A| |x|)``.
The window counts ``flops``, ``2 * nnz * nrhs`` a product.

Controls, each put in the program's place:

- ``reference_bf16``: the reference computed from bfloat16 values and
  operands (the nearest precision below float32);
- ``program_bf16``: the program's own bfloat16 path,
  ``plan_spmv(dtype=torch.bfloat16)``.
"""

from __future__ import annotations

import time

import torch

from gpu_bench.harness.traffic import (closed_loop, generator, make_plan,
                                       plan_dtype, sync)
from gpu_bench.reference import products as ref

CONTROLS = ("reference_bf16", "program_bf16")


class Kind:
    def __init__(self, mix, A, info, seed, device, spans, *, plan=None,
                 control=None):
        if control is not None and control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}")
        self.mix, self.A, self.device, self.control = mix, A, device, control
        self.nrhs = mix["nrhs"]
        shape = (A.shape[1],) if self.nrhs == 1 else (A.shape[1], self.nrhs)
        self.xs = [torch.rand(shape, generator=generator(device, seed, "x", j),
                              device=device)
                   for j in range(mix["vectors"])]
        self.plan = None
        if control == "reference_bf16":
            self.call = lambda x: ref.matmul(A, x, bf16=True)[0].float()
            return
        if plan is None:
            dtype = (torch.bfloat16 if control == "program_bf16"
                     else plan_dtype(mix))
            plan = make_plan(A, device, spans, dtype)
        self.plan = plan
        self.call = plan if self.nrhs == 1 else plan.spmm

    def step(self, i):
        return self.call(self.xs[i % len(self.xs)])

    def warm_up(self) -> float:
        """Every operand once, then ``warmup_calls`` more (a control, which
        nothing times, only the operands); the seconds a call took over
        the last half."""
        n = 2 * len(self.xs)
        if self.control is None:
            n = max(self.mix["warmup_calls"], n)
        for i in range(n // 2):
            self.step(i)
        sync(self.device)
        t = time.perf_counter()
        for i in range(n // 2, n):
            self.step(i)
        sync(self.device)
        return (time.perf_counter() - t) / (n - n // 2)

    def window(self, seconds, keep, traced=False):
        w = closed_loop(self.step, seconds, self.device, keep=keep)
        w.counters["flops"] = 2 * self.A.nnz * self.nrhs * w.calls
        return w

    def free(self):
        self.plan = self.call = None

    def readings(self, kept: dict) -> dict:
        """The componentwise error of each kept output, the reference
        worked out once an operand."""
        out = []
        for j in sorted({i % len(self.xs) for i in kept}):
            yref, yabs = ref.matmul(self.A, self.xs[j])
            out += [ref.componentwise_error(y, yref, yabs)
                    for i, y in kept.items() if i % len(self.xs) == j]
        return {"y_err": out}

    def check(self, w, limits: dict) -> tuple[dict, int]:
        errs = self.readings(w.kept)["y_err"]
        return ({"y_err": max(errs)},
                sum(e > limits["y_err"] for e in errs))
