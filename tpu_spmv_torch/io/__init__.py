"""Matrix I/O: MatrixMarket (pure Python + the C++ fast-path parser)."""

from .mmio import (MMHeader, read_header, read_matrix, read_mtx_arrays,
                   write_matrix)

__all__ = ["MMHeader", "read_header", "read_matrix", "read_mtx_arrays",
           "write_matrix"]
