"""BLAS-1 / dense-vector operations on tensors.

Counterpart of ``tpu_spmv/ops/blas1.py``, one function for one.  Each op
returns a new tensor, as the reference's do.
"""

from __future__ import annotations

import torch

__all__ = ["dot", "axpby", "axpy", "add2scaled", "fill", "fill_random",
           "scale", "shift", "norm2", "check_vector", "allclose"]


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """⟨x, y⟩."""
    return torch.dot(x, y)


def axpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    """``alpha*x + beta*y``."""
    return alpha * x + beta * y


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y + alpha*x``."""
    return y + alpha * x


def add2scaled(y: torch.Tensor, alpha, x1: torch.Tensor, beta,
               x2: torch.Tensor) -> torch.Tensor:
    """``y + alpha*x1 + beta*x2``."""
    return y + alpha * x1 + beta * x2


def fill(n: int, value, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """Constant vector."""
    return torch.full((n,), value, dtype=dtype, device=device)


def fill_random(generator: torch.Generator, n: int, *, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Uniform [0, 1) vector from ``generator`` (reproducible per seed)."""
    return torch.rand(n, generator=generator, dtype=dtype, device=device)


def scale(x: torch.Tensor, alpha) -> torch.Tensor:
    """``alpha * x``."""
    return alpha * x


def shift(x: torch.Tensor, alpha) -> torch.Tensor:
    """``x + alpha``."""
    return x + alpha


def norm2(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm."""
    return torch.sqrt(torch.dot(x, x))


def check_vector(x, y, tol: float = 1e-6) -> bool:
    """Elementwise absolute-tolerance compare."""
    return bool(torch.all(torch.abs(torch.as_tensor(x) - torch.as_tensor(y))
                          <= tol))


def allclose(x, y, rtol: float = 1e-10, atol: float = 0.0) -> bool:
    """Relative-tolerance compare (the 1e-10 float64 parity gate)."""
    return bool(torch.allclose(torch.as_tensor(x), torch.as_tensor(y),
                               rtol=rtol, atol=atol))
