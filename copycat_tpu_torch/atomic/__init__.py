"""Atomic resources (reference ``atomic/`` module, SURVEY.md §2.1):
``DistributedAtomicValue`` (linearizable register with TTL + change events) and
``DistributedAtomicLong`` (client-side CAS-retry counter on top of it)."""

from .value import DistributedAtomicValue
from .long import DistributedAtomicLong
from .state import AtomicValueState

__all__ = ["DistributedAtomicValue", "DistributedAtomicLong", "AtomicValueState"]
