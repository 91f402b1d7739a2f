"""The distributed plane of the port: the mesh's sharding rules and their
collectives (`shardings`), elastic re-meshing (`elastic`), and the
host-side replication plane: the wire protocol, socket replication (acks,
watermark, bootstrap, backpressure, fencing), the in-process loopback
channel and fault injection."""
from repro_torch.distributed.shardings import (
    ShardCtx, shard_ctx, current_ctx, batch_spec, param_specs,
    input_shardings,
)
from repro_torch.distributed.transport import (
    Transport, ReplicationServer, ReplicationClient, store_digest,
)
from repro_torch.distributed.replication import DeltaChannel, make_follower

__all__ = ["ShardCtx", "shard_ctx", "current_ctx", "batch_spec",
           "param_specs", "input_shardings", "Transport",
           "ReplicationServer", "ReplicationClient", "store_digest",
           "DeltaChannel", "make_follower"]
