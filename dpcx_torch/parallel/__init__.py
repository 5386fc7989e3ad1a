"""Parallelism over ``torch.distributed`` (port of ``dpcx/parallel/``): the
process mesh, batch sharding and the collectives with their gradients."""

from dpcx_torch.parallel.mesh import (
    Mesh,
    all_mean_,
    all_sum,
    gather_slots,
    init_from_env,
    make_mesh,
    mesh_shape,
    scale_grad,
    shard_batch,
    sum_grad,
)

__all__ = [
    "Mesh",
    "all_mean_",
    "all_sum",
    "gather_slots",
    "init_from_env",
    "make_mesh",
    "mesh_shape",
    "scale_grad",
    "shard_batch",
    "sum_grad",
]
