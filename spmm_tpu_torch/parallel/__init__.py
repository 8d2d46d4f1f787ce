"""Distribution on `torch.distributed`: process groups, meshes of ranks,
row-sharded sparse matrices, the sparse collectives and SUMMA.

Port of `spmm_tpu.parallel`: one process per rank (NCCL on the card, gloo
on the CPU), each holding its own shard; every op is called by every rank
of the mesh with its own part (SPMD)."""

from spmm_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    destroy_process_group,
    init_process_group,
    make_mesh,
    replicated,
    row_sharded,
)
from spmm_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedCSR,
    SpmvStreamPlan,
    shard_csr,
    shard_vector,
    sharded_to_csr,
    spgemm_dense_sharded,
    spgemm_sharded_sparse,
    spmm_sharded,
    spmv_sharded,
    spmv_sharded_blocked,
    spmv_sharded_streamed,
    spmv_stream_plan,
    spmv_t_sharded,
    unshard_rows,
)
from spmm_tpu_torch.parallel import collectives  # noqa: F401
from spmm_tpu_torch.parallel.summa import (  # noqa: F401
    make_mesh_2d,
    spgemm_summa,
)
