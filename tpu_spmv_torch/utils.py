"""Synthetic test-matrix generators and the native-library build helper.

The generators are the reference package's (``tpu_spmv/utils.py``), numpy
and scipy only, so both packages see identical operands:

- :func:`laplacian_2d` / :func:`laplacian_3d` — 5- and 7-point Poisson
  stencils, the planner's periodic-streaming-DIA citizens;
- :func:`banded` — random-valued band, the explicit streaming-DIA case;
- :func:`random_sparse` — uniform-random pattern, the general case;
- :func:`power_law` — power-law row lengths with hub rows, the general
  arm's load-imbalance case;
- :func:`block_laplacian` — the 2-D Laplacian pattern with dense blocks.
"""

from __future__ import annotations

import functools
import os
import subprocess

import numpy as np
import scipy.sparse as sp

__all__ = ["laplacian_2d", "laplacian_3d", "random_sparse", "banded",
           "block_laplacian", "power_law", "ensure_native_built"]


@functools.cache
def ensure_native_built() -> bool:
    """Build ``native/`` (the C++ MatrixMarket parser) on first use when
    its library is missing.  Best-effort: a failure leaves the pure-Python
    parser in place."""
    root = os.path.join(os.path.dirname(__file__), "..", "native")
    target = os.path.join(root, "libmmio_fast.so")
    if not os.path.exists(os.path.join(root, "Makefile")):
        return False
    if os.path.exists(target):
        return True
    try:
        subprocess.run(["make", "-C", root], check=True, timeout=120,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(target)


def laplacian_2d(nx: int, ny: int | None = None, dtype=np.float64) -> sp.csr_matrix:
    """5-point 2-D Laplacian on an ``nx × ny`` grid (SPD, pentadiagonal)."""
    ny = nx if ny is None else ny
    ex = np.ones(nx)
    ey = np.ones(ny)
    Tx = sp.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
    Ty = sp.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1])
    A = sp.kronsum(Tx, Ty, format="csr").astype(dtype)
    A.sort_indices()
    return A


def laplacian_3d(nx: int, ny: int | None = None, nz: int | None = None,
                 dtype=np.float64) -> sp.csr_matrix:
    """7-point 3-D Laplacian on an ``nx × ny × nz`` grid (SPD,
    heptadiagonal: offsets 0, ±1, ±nz, ±ny·nz)."""
    ny = nx if ny is None else ny
    nz = ny if nz is None else nz

    def T(m):
        e = np.ones(m)
        return sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1])

    A = sp.kronsum(sp.kronsum(T(nz), T(ny)), T(nx), format="csr")
    A = A.astype(dtype)
    A.sort_indices()
    return A


def random_sparse(
    nrow: int, ncol: int, density: float = 0.01, seed: int = 0, dtype=np.float64
) -> sp.csr_matrix:
    """Uniform random sparse matrix with standard-normal values."""
    rng = np.random.default_rng(seed)
    A = sp.random(
        nrow, ncol, density=density, random_state=rng,
        data_rvs=rng.standard_normal, format="csr", dtype=np.float64,
    ).astype(dtype)
    A.sum_duplicates()
    A.sort_indices()
    return A


def banded(n: int, bandwidth: int = 5, seed: int = 0, dtype=np.float64) -> sp.csr_matrix:
    """Dense band of half-width ``bandwidth`` around the main diagonal."""
    rng = np.random.default_rng(seed)
    offsets = list(range(-bandwidth, bandwidth + 1))
    diags = [rng.standard_normal(n - abs(k)) for k in offsets]
    A = sp.diags(diags, offsets, shape=(n, n), format="csr").astype(dtype)
    A.sort_indices()
    return A


def block_laplacian(nx: int, bs: int = 8, seed: int = 0,
                    dtype=np.float64) -> sp.csr_matrix:
    """Structured-PDE block matrix: 2-D Laplacian pattern with dense
    ``bs x bs`` blocks of standard-normal values (``bs`` coupled components
    per grid point)."""
    rng = np.random.default_rng(seed)
    pattern = laplacian_2d(nx)
    pattern_coo = pattern.tocoo()
    blocks = rng.standard_normal((pattern_coo.nnz, bs, bs))
    A = sp.bsr_matrix(
        (blocks, pattern_coo.col, pattern_coo.tocsr().indptr),
        shape=(pattern.shape[0] * bs, pattern.shape[1] * bs),
    ).tocsr().astype(dtype)
    A.sort_indices()
    return A


def power_law(
    nrow: int, ncol: int, avg_nnz_per_row: int = 8, alpha: float = 1.5,
    seed: int = 0, dtype=np.float64,
) -> sp.csr_matrix:
    """Rows with Pareto-distributed lengths (mean ``avg_nnz_per_row``,
    at least 1, at most ``ncol``) at distinct uniform-random columns, with
    standard-normal values: a few hub rows hold many entries."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, size=nrow) + 1.0
    lengths = np.minimum(
        np.maximum((raw * avg_nnz_per_row / raw.mean()).astype(np.int64), 1), ncol
    )
    rows = np.repeat(np.arange(nrow), lengths)
    cols = np.concatenate([
        rng.choice(ncol, size=l, replace=False) for l in lengths
    ])
    vals = rng.standard_normal(rows.size)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(nrow, ncol)).astype(dtype)
    A.sum_duplicates()
    A.sort_indices()
    return A
