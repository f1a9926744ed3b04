"""Splitting work over several devices from one process: a device mesh,
frame and row sharding, replication, the sharded pipeline steps and the
halo exchange of row-sharded stencils."""

from .mesh import (  # noqa: F401
    Mesh,
    Sharded,
    make_mesh,
    shard_frames,
    replicate,
    sharded_pipeline_step,
    sharded_engine_step,
    sharded_classic_pipeline,
)
from .halo import halo_exchange_rows, spatial_halo_call  # noqa: F401
