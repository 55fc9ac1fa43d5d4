"""Distribution layer: row-partitioned sharding over a mesh of devices.

Counterpart of ``tpu_spmv/dist``, with its single-controller model: one
process drives every shard, a :class:`Mesh` names each shard's device (one
device may hold several shards), halo exchanges are copies to a
neighbour's device and reductions sum in shard order.

| reference (NUMA/pthreads)              | here                              |
|----------------------------------------|-----------------------------------|
| ``numa_num_configured_nodes`` topology | ``make_mesh``                     |
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
from .mesh import Mesh, device_count, make_mesh
from .partition import RowPlan, plan_even, plan_rows, plan_uniform
from .planned import (DistPlan, ShardedBDIA, ShardedDIA, ShardedGPR,
                      ShardedPSDIA, ShardedSDIA, bench_dist_spmv,
                      plan_dist_spmv, spmv_bdia_sharded, spmv_dia_sharded,
                      spmv_gpr_sharded, spmv_psdia_sharded, spmv_sdia_sharded)
from .sharded import (ColShardedCSR, HaloCSR, NeighborCSR, ShardedCSR,
                      ShardedVector)
from .spmv import (place, spmv_allgather, spmv_colsplit, spmv_halo,
                   spmv_neighbor)

__all__ = [
    "RowPlan", "plan_rows", "plan_even", "plan_uniform",
    "ShardedVector", "ShardedCSR", "HaloCSR", "NeighborCSR",
    "ColShardedCSR",
    "spmv_allgather", "spmv_halo", "spmv_neighbor", "spmv_colsplit",
    "ShardedDIA", "ShardedBDIA", "ShardedSDIA", "ShardedPSDIA", "ShardedGPR",
    "spmv_dia_sharded", "spmv_bdia_sharded", "spmv_sdia_sharded",
    "spmv_psdia_sharded", "spmv_gpr_sharded",
    "DistPlan", "plan_dist_spmv", "bench_dist_spmv",
    "place",
    "Mesh", "make_mesh", "device_count",
    "blas",
]
