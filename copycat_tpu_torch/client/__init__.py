"""Raft client runtime (Copycat ``CopycatClient``/``RaftClient`` equivalent)."""

from .client import (
    AnyConnectionStrategy,
    ApplicationError,
    ClientSession,
    ConnectionStrategy,
    PinnedConnectionStrategy,
    RaftClient,
    SessionExpiredError,
)

__all__ = [
    "RaftClient",
    "ClientSession",
    "ConnectionStrategy",
    "AnyConnectionStrategy",
    "PinnedConnectionStrategy",
    "ApplicationError",
    "SessionExpiredError",
]
