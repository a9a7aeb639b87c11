"""Distributed collections (reference ``collections/`` module, SURVEY.md §2.1):
map, multimap, set, queue — each a client class + replicated state machine +
operation catalog with the reference's TTL and log-cleaning discipline."""

from .map import DistributedMap
from .multimap import DistributedMultiMap
from .set import DistributedSet
from .queue import DistributedQueue
from .state import MapState, MultiMapState, QueueState, SetState

__all__ = [
    "DistributedMap",
    "DistributedMultiMap",
    "DistributedSet",
    "DistributedQueue",
    "MapState",
    "MultiMapState",
    "SetState",
    "QueueState",
]
