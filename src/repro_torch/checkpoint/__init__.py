"""Checkpoints and the durable delta log of the port."""
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.wal import DeltaWAL, WireTee, recover_wal

__all__ = ["CheckpointManager", "DeltaWAL", "WireTee", "recover_wal"]
