"""Spatial sharding of the port over a (Y, X) mesh of shards."""

from cuda_iblb_11_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh, MeshState, ShardedPallasSim, ShardedTemporalSim, make_mesh,
    visible_devices,
)
