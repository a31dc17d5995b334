"""Atomic, checksummed snapshots of solver state (port of
``repro.checkpoint``)."""
from .manager import (CheckpointManager, SnapshotCorruptError,  # noqa: F401
                      latest_step, read_manifest, restore, save,
                      snapshot_steps)
