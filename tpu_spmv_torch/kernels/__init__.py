"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their packs.

Each kernel has a plain PyTorch version beside it that CPU tensors run;
CUDA tensors launch the kernel, built at first use (:mod:`._build`).

- :mod:`.dia_stream`: streaming DIA, K1 ``sdia_spmv`` and K2
  ``psdia_spmv`` (the walks of ``csrc/psdia_walk.cuh``, planned by
  ``psdia_walk_plan``, which K8b shares), their SpMMs K3a ``sdia_spmm``
  and K3b ``psdia_spmm`` (one body along the walks that
  ``psdia_spmm_plan`` picks);
- :mod:`.gpr`: class-sorted CSR with hub rows split, ``gpr_spmv`` and
  ``gpr_spmm``;
- :mod:`.ell_packed`: sliced ELL, ``ell_spmv`` and ``ell_spmm``;
- :mod:`.permute`: the permutation engine ``out[i] = x[perm[i]]``,
  ``permute_gather`` and ``permute_gather_batched``.
"""

from .dia_stream import (PSDIA, SDIA, detect_period, pack_psdia, pack_sdia,
                         spmm_psdia, spmm_sdia, spmv_psdia, spmv_sdia,
                         supports_sdia)
from .ell_packed import PackedELL, pack_ell, spmm_ell_packed, spmv_ell_packed
from .gpr import GPCSR, pack_gpr, spmm_gpr, spmv_gpr
from .permute import (PermutationPlan, apply_permutation,
                      apply_permutation_batched, apply_tile_permutation,
                      plan_permutation, plan_permutation_auto,
                      plan_tile_permutation)

__all__ = ["SDIA", "PSDIA", "pack_sdia", "pack_psdia", "detect_period",
           "supports_sdia", "spmv_sdia", "spmv_psdia", "spmm_sdia",
           "spmm_psdia",
           "GPCSR", "pack_gpr", "spmv_gpr", "spmm_gpr",
           "PackedELL", "pack_ell", "spmv_ell_packed", "spmm_ell_packed",
           "PermutationPlan", "plan_permutation", "plan_permutation_auto",
           "plan_tile_permutation", "apply_permutation",
           "apply_permutation_batched", "apply_tile_permutation"]
