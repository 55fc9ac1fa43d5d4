"""Shared operands and JAX-side plans for the port's solver tests.

The JAX reference plans a streaming-DIA operator on the CPU only with its
``_stream_on_cpu`` switch on and ``_STREAM_MIN_BYTES`` at 0; its Pallas
kernels then run in interpret mode.  :func:`reference_planning` sets both
for as long as a module needs them (module-scoped fixtures compute each
JAX result once).
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp

from tpu_spmv import utils
from tpu_spmv.ops import auto as jauto


@contextlib.contextmanager
def reference_planning():
    """The reference planner's streaming arms on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jauto, "_stream_on_cpu", True)
    mp.setattr(jauto, "_STREAM_MIN_BYTES", 0)
    try:
        yield jauto
    finally:
        mp.undo()


def rel(y, ref) -> float:
    """Largest absolute difference over the largest reference value."""
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def screened(g: int) -> sp.csr_matrix:
    """The screened 2-D Poisson ``laplacian_2d(g) + I`` (spectrum in
    ``[1, 9]``)."""
    m = utils.laplacian_2d(g)
    return (m + sp.identity(m.shape[0])).tocsr()


def convection(g: int) -> sp.csr_matrix:
    """A nonsymmetric operator: the screened Poisson plus 0.3 on its whole
    first superdiagonal (still periodic, so it plans to PSDIA)."""
    m = screened(g)
    n = m.shape[0]
    return (m + sp.diags([0.3 * np.ones(n - 1)], [1])).tocsr()


def rhs(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random(n)
