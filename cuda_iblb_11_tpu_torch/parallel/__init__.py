"""Spatial sharding of the port over a (Y, X) mesh of shards (sharded),
in one process or over the ranks of a --distributed run (dist)."""

from cuda_iblb_11_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh, MeshState, ShardedPallasSim, ShardedTemporalSim, make_mesh,
    visible_devices,
)
