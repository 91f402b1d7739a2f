"""The host-side plane of the port: the wire protocol, socket replication
(acks, watermark, bootstrap, backpressure, fencing), the in-process
loopback channel and fault injection.  Multi-card sharding is not ported
(see ROADMAP.md)."""
from repro_torch.distributed.transport import (
    Transport, ReplicationServer, ReplicationClient, store_digest,
)
from repro_torch.distributed.replication import DeltaChannel, make_follower

__all__ = ["Transport", "ReplicationServer", "ReplicationClient",
           "store_digest", "DeltaChannel", "make_follower"]
