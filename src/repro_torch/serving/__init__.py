"""Serving plane of the port: the cluster train/serve split on the card.

OCC training publishes immutable `ModelSnapshot` versions into a
`SnapshotStore`; a `ClusterService` answers batched assign / score / topk
queries against them with pad-to-bucket microbatching, hot swap, an
admission queue with priority lanes and shedding (`Query` /
`ServeConfig`), flat and hierarchical multi-probe top-k; a `ModelRouter`
puts many named models behind one front.  `ServeEngine` serves the
language model from a slot KV cache.  The port of `repro.serving`.
"""
from repro_torch.serving.qos import Query, ServeConfig
from repro_torch.serving.snapshot import (
    CenterDelta, CenterLog, DeltaSnapshot, ModelSnapshot, SnapshotStore,
    freeze_snapshot, next_bucket,
)
from repro_torch.serving.cluster_service import (
    ClusterService, DispatchRecord, ServeResponse,
)
from repro_torch.serving.router import ModelRouter
from repro_torch.serving.engine import ServeEngine

__all__ = ["ModelSnapshot", "SnapshotStore", "freeze_snapshot",
           "next_bucket", "ClusterService", "ServeResponse", "ModelRouter",
           "CenterDelta", "CenterLog", "DeltaSnapshot", "DispatchRecord",
           "Query", "ServeConfig", "ServeEngine"]
