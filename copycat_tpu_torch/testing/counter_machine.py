"""The replicated counter machine shared by the cluster-shaped benches
and the deployment plane's child processes (docs/DEPLOYMENT.md).

Lives OUTSIDE ``bench.py`` on purpose: a deployed member/ingress process
(``python -m copycat_tpu_torch.deploy.child``) imports this module by machine
spec (``copycat_tpu_torch.testing.counter_machine:counter_machine``) to host
the workload the compartment bench drives — importing ``bench.py`` for
the class would drag torch and the engine stack into every child, and the
serialization ids (940/941) must bind to exactly ONE class each, so the
bench and the children must share this definition.

Import of this module registers the op types with the serializer — any
process that decodes ``ClusterAdd`` frames (members, ingress proxies,
clients) must import it before the first frame arrives; the machine
spec on the topology does that for spawned children.
"""

from __future__ import annotations

import zlib

from ..io.serializer import serialize_with
from ..protocol.messages import Message
from ..protocol.operations import Command, Query
from ..server.state_machine import Commit, StateMachine


@serialize_with(940)
class ClusterAdd(Message, Command):
    _fields = ("key", "delta")


@serialize_with(941)
class ClusterGet(Message, Query):
    _fields = ("key",)


class CounterMachine(StateMachine):
    """Keyed counters: ``ClusterAdd`` increments, ``ClusterGet`` reads."""

    def __init__(self) -> None:
        super().__init__()
        self.data: dict = {}

    # explicit registration: the auto-register table resolves
    # annotations in module scope, and Commit is only imported here
    def configure(self, executor) -> None:
        executor.register(ClusterAdd, self.add)
        executor.register(ClusterGet, self.get)

    def add(self, commit: "Commit") -> int:
        op = commit.operation
        value = self.data.get(op.key, 0) + op.delta
        self.data[op.key] = value
        return value

    def get(self, commit: "Commit") -> int:
        return self.data.get(commit.operation.key, 0)

    # crash-recovery plane hooks (docs/DURABILITY.md): the recovery
    # scenario snapshots + restores this machine; the cluster
    # scenario's durable storage levels snapshot it too
    def snapshot_state(self):
        return {"data": dict(self.data)}

    def restore_state(self, data, sessions) -> None:
        self.data = dict(data["data"])

    # keyspace sharding (docs/SHARDING.md): counters route across Raft
    # groups by a stable key hash — identical on every member, every
    # ingress proxy, and across restarts
    @classmethod
    def route_group(cls, operation, groups: int) -> int:
        key = getattr(operation, "key", None)
        if isinstance(key, str):
            return zlib.crc32(key.encode()) % groups
        return 0


def counter_machine(group: int = 0) -> CounterMachine:
    """Per-group machine factory (the deployment plane's machine-spec
    entry point: ``copycat_tpu_torch.testing.counter_machine:counter_machine``)."""
    return CounterMachine()
