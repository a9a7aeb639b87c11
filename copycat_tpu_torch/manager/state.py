"""ResourceManager — THE multiplexer (reference ``ResourceManager.java:35``).

One replicated state machine hosting every resource:

- ``keys``: name -> resource id (= the creating commit's log index,
  ``ResourceManager.java:160``)
- ``resources``: resource id -> (state machine, per-resource executor)
- ``instances``: instance id -> (resource, virtual session, owner session)

Instance ops are routed to the owning resource's executor with the commit
re-parented onto the resource's virtual session (``operateResource:56``).
Session expiry/close fans out to every resource the session touched
(``ResourceManager.java:238-266``).
"""

from __future__ import annotations

import logging
import zlib
from typing import Any, Callable

from ..server.session import ServerSession, SessionState
from ..server.state_machine import Commit, StateMachine, StateMachineExecutor
from ..utils.metrics import MetricsRegistry
from ..resource.operations import ResourceCommand, ResourceQuery
from ..resource.state_machine import ResourceStateMachine, ResourceStateMachineExecutor
from .operations import (
    CreateResource,
    DeleteResource,
    GetResource,
    InstanceCommand,
    InstanceEvent,
    InstanceOperation,
    InstanceQuery,
    ResourceExists,
)


class ManagedResourceSession:
    """Per-(resource-instance) virtual session bound to a client session
    (reference ``ManagedResourceSession.java:38``): same lifecycle as the
    parent, but events are wrapped in InstanceEvent for client-side routing."""

    def __init__(self, instance_id: int, parent: ServerSession) -> None:
        self.id = instance_id
        self.parent = parent

    @property
    def state(self) -> SessionState:
        return self.parent.state

    @property
    def is_open(self) -> bool:
        return self.parent.is_open

    @property
    def timeout(self) -> float:
        return self.parent.timeout

    def publish(self, event: str, message: Any = None) -> None:
        self.parent.publish(event, InstanceEvent(self.id, message))

    def __repr__(self) -> str:
        return f"ManagedResourceSession(instance={self.id}, client={self.parent.id})"


class ManagerResourceExecutor(ResourceStateMachineExecutor):
    """Per-resource executor: own callback map and logger, timers tracked for
    cancel-on-delete (reference ``ResourceManagerStateMachineExecutor.java:43``)."""

    def __init__(self, parent: StateMachineExecutor, resource_id: int, name: str) -> None:
        super().__init__(parent)
        self._context_logger = logging.getLogger(f"{name}-{resource_id}")
        self._tracked: set[Any] = set()

    def logger(self) -> logging.Logger:
        return self._context_logger

    def schedule(self, delay: float, callback: Callable[[], None], interval=None):
        # One-shot timers untrack themselves on fire so a steady TTL workload
        # doesn't pin every fired timer (+ its commit closure) until delete.
        holder: dict[str, Any] = {}

        def wrapped() -> None:
            try:
                callback()
            finally:
                if interval is None and "timer" in holder:
                    self._tracked.discard(holder["timer"])

        timer = super().schedule(delay, wrapped, interval)
        holder["timer"] = timer
        self._tracked.add(timer)
        return timer

    def close(self) -> None:
        for timer in self._tracked:
            timer.cancel()
        self._tracked.clear()


class ResourceHolder:
    __slots__ = ("resource_id", "key", "state_machine", "executor",
                 "machine_cls")

    def __init__(self, resource_id: int, key: str,
                 state_machine: ResourceStateMachine,
                 executor: ManagerResourceExecutor,
                 machine_cls: type | None = None) -> None:
        self.resource_id = resource_id
        self.key = key
        self.state_machine = state_machine
        self.executor = executor
        # The LOGICAL machine class requested at create time — the actual
        # instance may be its device-backed equivalent when the manager
        # runs the TPU executor (device_executor.device_machine_for).
        self.machine_cls = machine_cls or type(state_machine)


class InstanceHolder:
    __slots__ = ("instance_id", "resource", "session", "owner")

    def __init__(self, instance_id: int, resource: ResourceHolder,
                 session: ManagedResourceSession, owner: ServerSession) -> None:
        self.instance_id = instance_id
        self.resource = resource
        self.session = session
        self.owner = owner


class _ReparentedCommit(Commit):
    """Commit view with the session swapped for the resource's virtual session
    (reference ``ResourceManagerCommit.java:31``)."""

    __slots__ = ("_parent",)

    def __init__(self, parent: Commit, session: ManagedResourceSession, operation: Any):
        super().__init__(parent.index, session, parent.time, operation, None)
        self._parent = parent

    def clean(self) -> None:
        self._parent.clean()

    def close(self) -> None:
        self._parent.close()


class ResourceManager(StateMachine):
    """The single top-level state machine wired into every server.

    ``executor="tpu"`` routes the fixed-shape resource types
    (value/long, map, set, queue, lock, leader election) to the in-process
    device engine — one device Raft group per resource — with the CPU
    state machines as the default and the automatic fallback for
    unsupported types and engine exhaustion (SURVEY.md §7.1; selection
    seam mirrors ``AtomixReplica.java:374``). The executor choice must be
    uniform across the cluster, like ``withStateMachine`` in the reference.
    """

    def __init__(self, executor: str = "cpu",
                 engine_config: Any | None = None,
                 group_id: int = 0, num_groups: int = 1,
                 engine: Any = None) -> None:
        super().__init__()
        if executor not in ("cpu", "tpu"):
            raise ValueError(f"unknown executor {executor!r}")
        self.keys: dict[str, int] = {}
        self.resources: dict[int, ResourceHolder] = {}
        self.instances: dict[int, InstanceHolder] = {}
        self.executor_kind = executor
        # Keyspace sharding (docs/SHARDING.md): on a multi-group server
        # each group hosts its own manager; resource/instance ids are
        # stamped ``index * num_groups + group_id`` so ids are globally
        # unique AND self-routing (``id % num_groups`` = owning group).
        # With num_groups == 1 the stamp is the identity — ids (and the
        # whole manager) are bit-identical to the unsharded plane.
        self.group_id = group_id
        self.num_groups = max(1, num_groups)
        # ``engine`` shares ONE DeviceEngine across the per-group
        # managers: every group's device-backed resources live in rows
        # of the same [G×P] tensor plane and compile once.
        self._engine: Any = engine
        self._engine_config = engine_config
        # Catalog counters feed inline; point-in-time gauges refresh in
        # stats() (the server's stats_snapshot pulls it — see
        # docs/OBSERVABILITY.md).
        self.metrics = MetricsRegistry()

    @classmethod
    def route_group(cls, operation: Any, groups: int) -> int:
        """Hash routing over the keyspace (docs/SHARDING.md): catalog
        ops route by a stable CRC of the resource key; instance ops are
        self-routing (ids carry their group residue). Deterministic
        across members, restarts, and processes — the stability contract
        tests/test_sharding.py pins."""
        t = type(operation)
        if t in (InstanceCommand, InstanceQuery):
            return operation.resource % groups
        if t is DeleteResource:
            return operation.instance_id % groups
        key = getattr(operation, "key", None)
        if isinstance(key, str):  # GetResource / CreateResource / Exists
            return zlib.crc32(key.encode()) % groups
        return 0

    @property
    def device_engine(self) -> Any:
        if self._engine is None and self.executor_kind == "tpu":
            from .device_executor import DeviceEngine
            self._engine = DeviceEngine(self._engine_config)
        return self._engine

    def prewarm(self) -> None:
        """Build + jit-compile the device engine up front (called at server
        open, before any client session exists — the first compile can take
        tens of seconds and must not stall keep-alives mid-session)."""
        if self.executor_kind == "tpu":
            self.device_engine._ensure()

    def begin_window(self) -> Any:
        """Open a shared device round pump for one apply batch (``None``
        on the CPU executor). The applying server defers device-backed
        handler chains into it so a batch of committed entries shares
        engine rounds instead of paying submit→commit→settle per op."""
        if self.executor_kind != "tpu":
            return None
        return self.device_engine.begin_window()

    # -- catalog ops -------------------------------------------------------

    def get_resource(self, commit: Commit[GetResource]) -> int:
        op = commit.operation
        holder = self._get_or_create_resource(commit, op.key, op.state_machine)
        # At most one instance per (resource, client session) for get()
        # (reference getResource:77-146).
        for instance in self.instances.values():
            if instance.resource is holder and instance.owner is commit.session:
                commit.clean()
                return instance.instance_id
        return self._create_instance(commit, holder).instance_id

    def create_resource(self, commit: Commit[CreateResource]) -> int:
        op = commit.operation
        holder = self._get_or_create_resource(commit, op.key, op.state_machine)
        return self._create_instance(commit, holder).instance_id

    def resource_exists(self, commit: Commit[ResourceExists]) -> bool:
        try:
            return commit.operation.key in self.keys
        finally:
            commit.close()

    def delete_resource(self, commit: Commit[DeleteResource]) -> bool:
        try:
            instance = self.instances.get(commit.operation.instance_id)
            if instance is None:
                return False
            holder = instance.resource
            holder.executor.close()
            try:
                holder.state_machine.delete()
            except Exception:
                logging.getLogger(__name__).exception("resource delete failed")
            self.keys.pop(holder.key, None)
            self.resources.pop(holder.resource_id, None)
            for iid in [i for i, h in self.instances.items() if h.resource is holder]:
                del self.instances[iid]
            self.metrics.counter("resources_deleted").inc()
            return True
        finally:
            commit.clean()

    # -- instance op routing ----------------------------------------------

    def instance_command(self, commit: Commit[InstanceCommand]) -> Any:
        return self._operate(commit)

    def instance_query(self, commit: Commit[InstanceQuery]) -> Any:
        return self._operate(commit)

    def _operate(self, commit: Commit) -> Any:
        op: InstanceOperation = commit.operation
        instance = self.instances.get(op.resource)
        if instance is None:
            commit.clean()
            raise ValueError(f"unknown resource instance {op.resource}")
        reparented = _ReparentedCommit(commit, instance.session, op.operation)
        return instance.resource.executor.execute(reparented)

    # -- batched server-side pump (vector lane) ---------------------------

    def vector_route(self, operation: Any):
        """Classify one committed operation for the applying server's
        vector lane: ``(machine, instance, inner_op, spec)`` when the op
        is a routed resource command whose device-backed machine can
        express it as ONE device op (``DeviceBackedStateMachine.
        vector_spec``), else ``None`` — the per-entry windowed apply
        handles everything else. Exact-type checks keep subclasses (which
        may override semantics) on the general path."""
        if type(operation) is not InstanceCommand:
            return None
        envelope = operation.operation
        if type(envelope) is not ResourceCommand:
            return None
        instance = self.instances.get(operation.resource)
        if instance is None:
            return None
        machine = instance.resource.state_machine
        spec_fn = getattr(machine, "vector_spec", None)
        if spec_fn is None:
            return None
        inner = envelope.operation
        spec = spec_fn(inner)
        if spec is None:
            return None
        return machine, instance, inner, spec

    def apply_key(self, operation: Any):
        """Dependency key for the applying server's parallel-apply
        classifier (docs/SHARDING.md "Apply ordering"): the catalog
        RESOURCE an operation mutates — stable resource id, identical on
        every member (``index * num_groups + group_id`` stamping) — or
        ``None`` when the footprint is not a single live resource
        (catalog create/get/delete, unknown instances): the conservative
        whole-window barrier. Instances of one key share a resource (and
        its device group), so two instances of the same map collide on
        the same key — exactly the FIFO the classifier must preserve."""
        if type(operation) is not InstanceCommand:
            return None
        instance = self.instances.get(operation.resource)
        if instance is None:
            return None
        return instance.resource.resource_id

    # -- batched read pump (query vector lane) -----------------------------

    def query_route(self, operation: Any):
        """Classify one READ for the applying server's read window:
        ``(machine, instance, inner_op, spec)`` when the op is a routed
        resource query whose device-backed machine can serve it as ONE
        device query (``DeviceBackedStateMachine.query_spec``), else
        ``None`` — the per-op query lane handles everything else
        (catalog queries, host-shadowed state, CPU machines). Exact-type
        checks keep subclasses on the general path, like
        :meth:`vector_route`."""
        if type(operation) is not InstanceQuery:
            return None
        envelope = operation.operation
        if type(envelope) is not ResourceQuery:
            return None
        instance = self.instances.get(operation.resource)
        if instance is None:
            return None
        machine = instance.resource.state_machine
        spec_fn = getattr(machine, "query_spec", None)
        if spec_fn is None:
            return None
        inner = envelope.operation
        spec = spec_fn(inner)
        if spec is None:
            return None
        return machine, instance, inner, spec

    # -- edge read tier (docs/EDGE_READS.md) -------------------------------

    def edge_locate(self, operation: Any):
        """``(resource_id, instance_id)`` when ``operation`` is a routed
        resource read of a live instance — the subscription handle the
        edge tier registers under (deltas are keyed by the RESOURCE the
        apply path mutates, :meth:`apply_key`; the client addresses its
        replica by the instance id it queries through). ``None``
        otherwise. Exact-type checks keep subclasses on the server
        path, like :meth:`query_route`."""
        if type(operation) is not InstanceQuery:
            return None
        if type(operation.operation) is not ResourceQuery:
            return None
        instance = self.instances.get(operation.resource)
        if instance is None:
            return None
        return instance.resource.resource_id, operation.resource

    def edge_state_of(self, resource_id: int) -> Any:
        """Tagged edge state of one resource (the machine's
        ``edge_state`` hook): ``NotImplemented`` when the machine never
        serves edge reads, ``None`` when the resource is gone — the
        subscriber's replica entry must retire."""
        holder = self.resources.get(resource_id)
        if holder is None:
            return None
        return holder.state_machine.edge_state()

    # -- internals ---------------------------------------------------------

    def _get_or_create_resource(self, commit: Commit, key: str,
                                machine_cls: type) -> ResourceHolder:
        resource_id = self.keys.get(key)
        if resource_id is not None:
            holder = self.resources[resource_id]
            if holder.machine_cls is not machine_cls:
                commit.clean()
                raise ValueError(
                    f"resource '{key}' exists with type "
                    f"{holder.machine_cls.__name__}, not {machine_cls.__name__}")
            return holder
        resource_id = commit.index * self.num_groups + self.group_id
        self.keys[key] = resource_id
        machine = self._instantiate_machine(machine_cls)
        executor = ManagerResourceExecutor(self.executor, resource_id, key)
        machine.init(executor)
        holder = ResourceHolder(resource_id, key, machine, executor,
                                machine_cls=machine_cls)
        self.resources[resource_id] = holder
        self.metrics.counter("resources_created").inc()
        return holder

    def _instantiate_machine(self, machine_cls: type) -> ResourceStateMachine:
        """CPU machine by default; its device-backed equivalent when the
        TPU executor is selected, the type is device-eligible, and the
        engine still has a free group (fallback otherwise)."""
        if self.executor_kind == "tpu":
            from .device_executor import device_machine_for
            device_cls = device_machine_for(
                machine_cls, self.device_engine.config.resource)
            if device_cls is not None:
                group = self.device_engine.allocate()
                if group is not None:
                    return device_cls(self.device_engine, group)
        return machine_cls()

    def _create_instance(self, commit: Commit, holder: ResourceHolder) -> InstanceHolder:
        instance_id = commit.index * self.num_groups + self.group_id
        session = ManagedResourceSession(instance_id, commit.session)
        instance = InstanceHolder(instance_id, holder, session, commit.session)
        self.instances[instance_id] = instance
        holder.state_machine.register(session)
        return instance

    # -- snapshot hooks (crash-recovery plane, docs/DURABILITY.md) ---------

    def snapshot_state(self) -> Any:
        """Serialize the whole resource catalog + machine state.

        Device-backed machines need no per-machine serialization: ALL of
        their replicated state lives in the engine's ``RaftGroups``
        pytree, captured wholesale through ``models/checkpoint.py``'s
        field-path ``.npz`` format (one blob for every device resource).
        CPU machines participate through their own
        ``snapshot_state``/``restore_state`` hooks; a live CPU machine
        WITHOUT hooks makes the whole manager opt out (returns
        ``NotImplemented``) — the server then stays on the replay-only
        recovery path rather than persist a lossy image.
        """
        resources = []
        for rid, holder in self.resources.items():
            machine = holder.state_machine
            state = machine.snapshot_state()
            if state is NotImplemented:
                logging.getLogger(__name__).info(
                    "resource %r (%s) cannot snapshot; manager stays "
                    "on replay-only recovery", holder.key,
                    type(machine).__name__)
                return NotImplemented
            resources.append({
                "id": rid, "key": holder.key, "cls": holder.machine_cls,
                "group": getattr(machine, "_group", None), "state": state})
        instances = [
            {"id": iid, "resource": inst.resource.resource_id,
             "owner": inst.owner.id}
            for iid, inst in self.instances.items()]
        engine_blob = None
        next_group = 0
        free: list[int] = []
        if self._engine is not None and self._engine._groups is not None:
            from ..models import checkpoint
            engine_blob = checkpoint.save_bytes(self._engine._groups)
            next_group = self._engine._next_group
            free = sorted(self._engine._free)
        return {"keys": dict(self.keys), "resources": resources,
                "instances": instances, "engine": engine_blob,
                "engine_next_group": next_group, "engine_free": free}

    def restore_state(self, data: Any, sessions: dict) -> None:
        # build the whole catalog into locals FIRST: a failure partway
        # (bad blob, machine restore raising) leaves this manager's live
        # dicts untouched, so the server's full-replay fallback starts
        # from pristine state instead of a half-restored catalog
        engine_restored = False
        if data["engine"] is not None and self.executor_kind == "tpu":
            self.device_engine.restore_snapshot(
                data["engine"], data["engine_next_group"],
                data["engine_free"])
            engine_restored = True
        resources: dict[int, ResourceHolder] = {}
        try:
            for rec in data["resources"]:
                machine_cls = rec["cls"]
                if rec["group"] is not None and self.executor_kind == "tpu":
                    from .device_executor import device_machine_for
                    device_cls = device_machine_for(
                        machine_cls, self.device_engine.config.resource)
                    machine = device_cls(self.device_engine, rec["group"])
                else:
                    machine = machine_cls()
                executor = ManagerResourceExecutor(
                    self.executor, rec["id"], rec["key"])
                machine.init(executor)
                machine.restore_state(rec["state"], sessions)
                resources[rec["id"]] = ResourceHolder(
                    rec["id"], rec["key"], machine, executor,
                    machine_cls=machine_cls)
        except Exception:
            if engine_restored:
                # the full-replay fallback re-applies history from index
                # 1; it must not land on snapshot-state device groups —
                # drop the restored RaftGroups so the next _ensure()
                # builds fresh
                eng = self._engine
                eng._groups = None
                eng._next_group = 0
                eng._free = []
            raise
        instances: dict[int, InstanceHolder] = {}
        for rec in data["instances"]:
            owner = sessions.get(rec["owner"])
            holder = resources.get(rec["resource"])
            if owner is None or holder is None:
                continue  # the owning session died with the snapshot
            session = ManagedResourceSession(rec["id"], owner)
            instances[rec["id"]] = InstanceHolder(
                rec["id"], holder, session, owner)
            # re-register so machines that track sessions re-bind them
            # (device machines re-attach listeners from device state)
            holder.state_machine.register(session)
        self.keys = dict(data["keys"])
        self.resources = resources
        self.instances = instances

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Catalog stats for the server's ``stats_snapshot()``: resource
        and instance gauges, create/delete counters, device-engine group
        occupancy when the TPU executor is live."""
        m = self.metrics
        m.gauge("resources").set(len(self.resources))
        m.gauge("instances").set(len(self.instances))
        device_backed = sum(
            1 for h in self.resources.values()
            if getattr(h.state_machine, "_group", None) is not None)
        m.gauge("resources_device_backed").set(device_backed)
        if self._engine is not None:
            groups_used = getattr(self._engine, "_next_group", None)
            if groups_used is not None:
                m.gauge("device_groups_used").set(int(groups_used))
        out = m.snapshot()
        out["executor"] = self.executor_kind
        # device-plane flight-recorder telemetry (models/telemetry.py):
        # the engine's device.* family + invariant-monitor summary ride
        # the manager section of /stats when telemetry is live
        groups = getattr(self._engine, "_groups", None)
        hub = getattr(groups, "telemetry", None)
        if hub is not None:
            out["device"] = hub.snapshot()
            out["device"]["invariants"] = hub.monitor.summary()
        return out

    # -- session lifecycle fan-out (SURVEY.md §3.4) ------------------------

    def expire(self, session: ServerSession) -> None:
        for instance in list(self.instances.values()):
            if instance.owner is session:
                instance.resource.state_machine.expire(instance.session)

    def close(self, session: ServerSession) -> None:
        for iid, instance in list(self.instances.items()):
            if instance.owner is session:
                instance.resource.state_machine.close(instance.session)
                del self.instances[iid]
