"""Distribution layer: row-partitioned sharding over a mesh of devices.

Counterpart of ``tpu_spmv/dist``.  One distributed code runs on two kinds
of mesh (:mod:`.mesh`): the single controller's :class:`Mesh`, where one
process drives every shard and names each shard's device (one device may
hold several shards), and the :class:`ProcessMesh` of one process a shard
over ``torch.distributed`` (:func:`init_multihost`, then
:func:`make_mesh`).  Only the mesh's exchanges differ — copies to a
neighbour's device, or collectives — and every reduction sums in shard
order, so both give the same bits.

| reference (NUMA/pthreads)              | here                              |
|----------------------------------------|-----------------------------------|
| ``numa_num_configured_nodes`` topology | ``make_mesh``                     |
| (single process)                       | ``init_multihost`` → process mesh |
| even row split                         | ``plan_rows`` (nnz-balanced)      |
| ``numa_alloc_onnode`` + memcpy slices  | ``ShardedCSR.build`` + ``place``  |
| full-x replication per thread          | ``spmv_allgather``                |
| (absent)                               | ``spmv_halo``, ``spmv_neighbor``  |
| per-thread fast local kernel           | ``plan_dist_spmv`` → sharded DIA, |
|                                        | streaming DIA (K8a/K8b), BDIA,    |
|                                        | GPR                               |
| CSC column slabs, y never reduced      | ``spmv_colsplit`` (y summed)      |
"""

from . import blas
from .mesh import Mesh, ProcessMesh, device_count, init_multihost, make_mesh
from .partition import RowPlan, plan_even, plan_rows, plan_uniform
from .planned import (DistPlan, ShardedBDIA, ShardedDIA, ShardedGPR,
                      ShardedPSDIA, ShardedSDIA, bench_dist_spmv,
                      plan_dist_spmv, predict_dist_costs, spmv_bdia_sharded,
                      spmv_dia_sharded, spmv_gpr_sharded, spmv_psdia_sharded,
                      spmv_sdia_sharded)
from .sharded import (ColShardedCSR, HaloCSR, NeighborCSR, ShardedCSR,
                      ShardedVector)
from .spmv import (place, spmm_allgather, spmm_halo, spmm_neighbor,
                   spmv_allgather, spmv_colsplit, spmv_halo, spmv_neighbor)

__all__ = [
    "RowPlan", "plan_rows", "plan_even", "plan_uniform",
    "ShardedVector", "ShardedCSR", "HaloCSR", "NeighborCSR",
    "ColShardedCSR",
    "spmv_allgather", "spmv_halo", "spmv_neighbor", "spmv_colsplit",
    "spmm_allgather", "spmm_halo", "spmm_neighbor",
    "ShardedDIA", "ShardedBDIA", "ShardedSDIA", "ShardedPSDIA", "ShardedGPR",
    "spmv_dia_sharded", "spmv_bdia_sharded", "spmv_sdia_sharded",
    "spmv_psdia_sharded", "spmv_gpr_sharded",
    "DistPlan", "plan_dist_spmv", "bench_dist_spmv", "predict_dist_costs",
    "place",
    "Mesh", "ProcessMesh", "make_mesh", "device_count", "init_multihost",
    "blas",
]
