"""The node axis split over a shard mesh (port of
``partisan_tpu/parallel``): S threads of one process, one per shard,
meeting at collectives (``mesh.py``), and the sharded cluster that runs
the round in them (``sharded.py``)."""

from partisan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, RendezvousError, force_host_devices, make_mesh, shard_count)
from partisan_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardComm, ShardedCluster)
