"""Matrix I/O: MatrixMarket (pure Python + the C++ fast-path parser),
dense vectors, and checkpoints of converted and packed matrices."""

from .checkpoint import load_matrix, load_vector, save_matrix, save_vector
from .mmio import (MMHeader, read_dense, read_header, read_matrix,
                   read_mtx_arrays, write_dense, write_matrix)

__all__ = ["MMHeader", "read_header", "read_matrix", "read_mtx_arrays",
           "write_matrix", "read_dense", "write_dense", "save_matrix",
           "load_matrix", "save_vector", "load_vector"]
