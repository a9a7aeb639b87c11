"""Concurrency and lifecycle utilities (Catalyst ``io.atomix.catalyst.util`` equivalent).

Reference behaviors reconstructed from consumed API surface (SURVEY.md §2.3):
``Listener``/``Listeners`` (closeable callback registrations), ``Managed``
(open/close lifecycle), ``Assert``, ``Scheduled`` (cancellable timers),
``ThreadContext`` (per-node serialized execution context -> here an asyncio
task-group bound to the shared event loop).
"""

from .assertions import check_arg, check_not_null, check_state
from .listeners import Listener, Listeners
from .managed import Managed
from .metrics import Counter, Histogram, MetricsRegistry, Timer
from .scheduled import Scheduled

__all__ = [
    "check_arg",
    "check_not_null",
    "check_state",
    "Counter",
    "Histogram",
    "Listener",
    "Listeners",
    "Managed",
    "MetricsRegistry",
    "Scheduled",
    "Timer",
]
