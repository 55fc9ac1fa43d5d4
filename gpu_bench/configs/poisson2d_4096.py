"""The 5-point 2-D Poisson operator on a ``grid[0] x grid[1]`` grid.

Row ``i = r * grid[1] + c``: 4 on the diagonal and -1 at ``i -
grid[1]``, ``i - 1``, ``i + 1``, ``i + grid[1]`` where those neighbours
exist.  The matrix does not depend on the seed."""

from __future__ import annotations

import numpy as np

from gpu_bench.reference.products import HostCSR


def build(cfg: dict, seed: int, device) -> tuple[HostCSR, dict]:
    """The host CSR (float64 values) and what a solver may know of it."""
    g1, g2 = cfg["grid"]
    n = g1 * g2
    idx = np.arange(n, dtype=np.int32)
    r, c = idx // g2, idx % g2
    cols = np.stack([idx - g2, idx - 1, idx, idx + 1, idx + g2], axis=1)
    keep = np.stack([r > 0, c > 0, np.ones(n, bool), c < g2 - 1,
                     r < g1 - 1], axis=1)
    vals = np.broadcast_to(np.array([-1.0, -1.0, 4.0, -1.0, -1.0]),
                           cols.shape)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    return (HostCSR(indptr, cols[keep], vals[keep], (n, n)),
            {"grid": (g1, g2)})


def bytes_moved(cfg: dict, A: HostCSR, nrhs: int) -> int:
    """x read once, y written once, and the 5 distinct coefficient
    diagonals over one period of ``grid[1]`` rows, in float32; the pack's
    layout and padding do not count."""
    return 4 * (2 * A.shape[0] * nrhs + 5 * cfg["grid"][1])
