"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their packs.

Each kernel has a plain PyTorch version beside it that CPU tensors run;
CUDA tensors launch the kernel, built at first use (:mod:`._build`).
"""

from .dia_stream import (PSDIA, SDIA, detect_period, pack_psdia, pack_sdia,
                         spmv_psdia, spmv_sdia, supports_sdia)

__all__ = ["SDIA", "PSDIA", "pack_sdia", "pack_psdia", "detect_period",
           "supports_sdia", "spmv_sdia", "spmv_psdia"]
