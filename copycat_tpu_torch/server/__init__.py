"""The Raft consensus core (Copycat ``CopycatServer`` equivalent), CPU oracle.

This is the always-correct reference implementation of the consensus layer the
TPU engine (``copycat_tpu_torch.models``) batches over groups.  Layout:

- ``log``      — entry types, segmented log, Storage levels, clean()/compaction,
  prefix truncation behind snapshots, the fsync policy
- ``state_machine`` — the StateMachine SPI: Commit, executor, log-time timers,
  snapshot_state/restore_state hooks
- ``session``  — server-side sessions: exactly-once, event push queues
- ``snapshot`` — atomic CRC-framed snapshot files (the crash-recovery plane)
- ``raft``     — RaftServer: roles (follower/candidate/leader), RPCs, apply loop
"""

from .log import (
    CommandEntry,
    ConfigurationEntry,
    Entry,
    KeepAliveEntry,
    Log,
    NoOpEntry,
    RegisterEntry,
    Storage,
    StorageLevel,
    UnregisterEntry,
)
from .snapshot import SnapshotStore
from .state_machine import Commit, StateMachine, StateMachineContext, StateMachineExecutor
from .session import ServerSession
from .raft import RaftServer

__all__ = [
    "Entry",
    "RegisterEntry",
    "KeepAliveEntry",
    "UnregisterEntry",
    "CommandEntry",
    "NoOpEntry",
    "ConfigurationEntry",
    "Log",
    "Storage",
    "StorageLevel",
    "Commit",
    "StateMachine",
    "StateMachineContext",
    "StateMachineExecutor",
    "ServerSession",
    "SnapshotStore",
    "RaftServer",
]
