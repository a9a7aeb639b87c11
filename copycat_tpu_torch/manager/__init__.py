"""Resource manager: many logical state machines over ONE replicated log.

The defining architectural move of the reference (SURVEY.md §1): the server
runs a single top-level state machine — :class:`ResourceManager` — that hosts
every resource behind per-resource virtual sessions and executors
(``ResourceManager.java:35``); the client virtualizes with
:class:`InstanceClient`/:class:`InstanceSession` (``InstanceClient.java:35``).
On the TPU engine this multiplexing IS the batch dimension: group g = one
resource's Raft-replicated state machine.
"""

from .operations import (
    CreateResource,
    DeleteResource,
    GetResource,
    InstanceCommand,
    InstanceEvent,
    InstanceQuery,
    KeyOperation,
    ResourceExists,
)
from .state import ManagedResourceSession, ResourceManager
from .instance import InstanceClient, InstanceSession
from .atomix import Atomix, AtomixClient, AtomixReplica, AtomixServer

__all__ = [
    "KeyOperation",
    "GetResource",
    "CreateResource",
    "DeleteResource",
    "ResourceExists",
    "InstanceCommand",
    "InstanceQuery",
    "InstanceEvent",
    "ResourceManager",
    "ManagedResourceSession",
    "InstanceClient",
    "InstanceSession",
    "Atomix",
    "AtomixClient",
    "AtomixReplica",
    "AtomixServer",
]
