"""HProt async checkpoint/restart subsystem (DESIGN.md §16).

:class:`AsyncCheckpointManager` — snapshot-consistent device-side cut,
staged writer lanes (thread/process), ordered fsync-then-manifest
commits, incremental delta checkpoints with periodic full rebase, and
checksum-verified elastic restore.
"""
from .lanes import CKPT_BACKENDS, CkptLaneBackend, register_backend
from .manager import AsyncCheckpointManager
from .restore import (CorruptShardError, context_complete,
                      latest_complete_step, verified_reader)

__all__ = [
    "AsyncCheckpointManager", "CorruptShardError", "CKPT_BACKENDS",
    "CkptLaneBackend", "register_backend", "context_complete",
    "latest_complete_step", "verified_reader",
]
