"""Training across several devices on `torch.distributed` (port of
`radargnn_tpu/parallel/`): the mesh of ranks and the sharded batch
(`mesh`), the explicit collectives and a launcher of local ranks (`comm`),
edge-partitioned reductions (`edge_partition`), the halo exchange
(`halo`) composed with the dense and windowed aggregations (`halo_dense`,
`halo_windowed`), column-parallel weights (`tensor`) and a one-step dry
run of the sharded paths (`dryrun`)."""

from radargnn_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, init_distributed, make_mesh, shard_batch,
)
