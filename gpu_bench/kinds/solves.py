"""``solvers.cg(plan, b, tol, maxiter, precond=mg_preconditioner(grid))``
back to back, as the CLI's ``--solve mgpcg`` runs it (``precond`` is
``multigrid``), cycling over ``rhs`` right-hand sides ``b = A x_true``:
``x_true`` uniform in [0, 1) from the seed, ``b`` worked out by the
float64 reference in set-up and rounded to float32.  The reference's
seconds there are not set-up's: they go to ``spans["setup_reference_s"]``.
Each solve is timed from its call to a synchronise after it returns.

Each kept answer's true relative residual ``||b - A x|| / ||b||`` is
worked out by the reference: ``residual``.  A solve whose own flag says
it did not converge fails too.  The window counts each solve's
``iterations``; a traced one also records CUDA events around every
application of the preconditioner, read after the window:
``spans["vcycle_ms"]``, one entry an application.

Controls, each put in the program's place:

- ``tol_1e-3``: the same solves stopped at ``tol=1e-3``;
- ``answer_bf16``: each answer held in bfloat16.
"""

from __future__ import annotations

import time

import torch

from gpu_bench.harness.traffic import (closed_loop, generator, make_plan,
                                       plan_dtype, sync)
from gpu_bench.reference import products as ref

CONTROLS = ("tol_1e-3", "answer_bf16")
LOOSE_TOL = 1e-3


class Kind:
    def __init__(self, mix, A, info, seed, device, spans, *, plan=None,
                 control=None):
        from tpu_spmv_torch import solvers

        if control is not None and control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}")
        if mix["precond"] != "multigrid":
            raise ValueError(f"unknown preconditioner {mix['precond']!r}")
        self.mix, self.A, self.device, self.control = mix, A, device, control
        self.cg = solvers.cg
        self.tol = LOOSE_TOL if control == "tol_1e-3" else mix["tol"]
        t = time.perf_counter()
        x_true = torch.rand((A.shape[1], mix["rhs"]), dtype=torch.float64,
                            generator=generator(device, seed, "x_true"),
                            device=device)
        B = ref.matmul(A, x_true)[0].float()
        self.bs = [B[:, j].contiguous() for j in range(mix["rhs"])]
        del x_true, B
        sync(device)
        spans["setup_reference_s"] = time.perf_counter() - t
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        if plan is None:
            plan = make_plan(A, device, spans, plan_dtype(mix))
        self.plan = plan
        self.precond = solvers.mg_preconditioner(info["grid"])

    def solve(self, i, precond, counters):
        res = self.cg(self.plan, self.bs[i % len(self.bs)], tol=self.tol,
                      maxiter=self.mix["maxiter"], precond=precond)
        counters["iterations"].append(res.iterations)
        counters["converged"].append(res.converged)
        if self.control == "answer_bf16":
            return res.x.to(torch.bfloat16).float()
        return res.x

    def warm_up(self) -> float:
        t = 0.0
        counters = {"iterations": [], "converged": []}
        for i in range(self.mix["warmup_calls"]):
            t0 = time.perf_counter()
            self.solve(i, self.precond, counters)
            sync(self.device)
            t = time.perf_counter() - t0
        return t

    def window(self, seconds, keep, traced=False):
        counters = {"iterations": [], "converged": []}
        precond, events = self.precond, []
        if traced and self.device.type == "cuda":
            inner = self.precond

            def precond(r):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                z = inner(r)
                e1.record()
                events.append((e0, e1))
                return z

        w = closed_loop(lambda i: self.solve(i, precond, counters), seconds,
                        self.device, keep=keep, timed=True)
        w.counters.update(counters)
        if events:
            w.spans["vcycle_ms"] = [a.elapsed_time(b) for a, b in events]
        return w

    def free(self):
        self.plan = self.precond = None

    def readings(self, kept: dict) -> dict:
        """The true relative residual of each kept solve (float64)."""
        idx = sorted(kept)
        return {"residual": ref.relative_residuals(
            self.A, torch.stack([self.bs[i % len(self.bs)] for i in idx], 1),
            torch.stack([kept[i] for i in idx], 1))}

    def check(self, w, limits: dict) -> tuple[dict, int]:
        res = self.readings(w.kept)["residual"]
        unconverged = sum(not bool(c) for c in w.counters["converged"])
        return ({"residual": max(res)},
                sum(r > limits["residual"] for r in res) + unconverged)
