"""Topology specs for the deployment plane (docs/DEPLOYMENT.md).

A :class:`TopologySpec` is the whole deployable shape in one value:
N Raft members hosting G groups each, plus an optional standalone
ingress/proxy tier of wire-facing processes — every role with its own
port, stats port and (for members) log directory. The
:class:`~copycat_tpu_torch.deploy.supervisor.Supervisor` launches one OS
process per spec entry via the argv each spec renders
(``python -m copycat_tpu_torch.deploy.child <role> ...``), so a spec is also
an exact, reproducible description of what ran.

Import-light on purpose (stdlib only): the supervisor, the CLI and the
tests all load specs without touching torch or the server stack.
"""

from __future__ import annotations

import json
import os
import socket
import sys
from dataclasses import asdict, dataclass, field


def allocate_ports(n: int, host: str = "127.0.0.1") -> list[int]:
    """``n`` free TCP ports via the bind-port-0 probe: every socket is
    held open until ALL are bound (so the kernel cannot hand the same
    port out twice within one call), then released together. The
    standard ephemeral-port idiom — a parallel CI run or a leftover
    listener on a hardcoded port can no longer collide
    (tests/test_cluster_processes.py used to pin 19361-19363)."""
    socks: list[socket.socket] = []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@dataclass
class MemberSpec:
    """One Raft member process: hosts every group's log + apply plane."""

    name: str
    address: str  # host:port the Raft transport listens on
    peers: list[str]  # every member's address, self included
    stats_port: int
    log_dir: str
    storage: str = "disk"  # memory | mapped | disk
    groups: int = 1
    machine: str | None = None  # "module:factory" (None = ResourceManager)
    role: str = "member"

    def argv(self) -> list[str]:
        out = [sys.executable, "-m", "copycat_tpu_torch.deploy.child",
               "member", self.address,
               *[a for a in self.peers if a != self.address],
               "--name", self.name,
               "--stats-port", str(self.stats_port),
               "--log-dir", self.log_dir,
               "--storage", self.storage,
               "--groups", str(self.groups)]
        if self.machine:
            out += ["--machine", self.machine]
        return out


@dataclass
class IngressSpec:
    """One standalone ingress/proxy process: owns client connections +
    global ingress batching, forwards sealed sub-blocks to group
    leaders (docs/DEPLOYMENT.md "The ingress tier")."""

    name: str
    address: str  # host:port clients connect to
    members: list[str]  # the Raft members this proxy fronts
    peers: list[str]  # the whole ingress tier, self included
    stats_port: int
    groups: int = 1
    machine: str | None = None
    role: str = "ingress"

    def argv(self) -> list[str]:
        out = [sys.executable, "-m", "copycat_tpu_torch.deploy.child",
               "ingress", self.address,
               "--members", ",".join(self.members),
               "--peers", ",".join(self.peers),
               "--name", self.name,
               "--stats-port", str(self.stats_port),
               "--groups", str(self.groups)]
        if self.machine:
            out += ["--machine", self.machine]
        return out


@dataclass
class TopologySpec:
    """Members × groups × optional ingress tier — the deployable shape."""

    members: list[MemberSpec] = field(default_factory=list)
    ingresses: list[IngressSpec] = field(default_factory=list)
    groups: int = 1
    base_dir: str | None = None  # member log dirs live under it
    control_port: int = 0  # supervisor control listener (0 = ephemeral)

    @classmethod
    def local(cls, members: int = 3, ingresses: int = 1, groups: int = 1,
              base_dir: str | None = None, storage: str = "disk",
              machine: str | None = None, host: str = "127.0.0.1",
              control_port: int = 0) -> "TopologySpec":
        """A loopback topology with every port ephemeral (one
        :func:`allocate_ports` call covers the whole shape, so no two
        roles — or two concurrently-built topologies — can collide)."""
        if members < 1:
            raise ValueError("a topology needs at least one member")
        if ingresses < 0:
            raise ValueError("ingresses must be >= 0")
        ports = allocate_ports(2 * (members + ingresses), host)
        member_ports = ports[:members]
        member_stats = ports[members:2 * members]
        ingress_ports = ports[2 * members:2 * members + ingresses]
        ingress_stats = ports[2 * members + ingresses:]
        member_addrs = [f"{host}:{p}" for p in member_ports]
        ingress_addrs = [f"{host}:{p}" for p in ingress_ports]
        base = base_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"),
            f"copycat-topology-{os.getpid()}-{member_ports[0]}")
        spec = cls(groups=groups, base_dir=base, control_port=control_port)
        for i in range(members):
            spec.members.append(MemberSpec(
                name=f"member-{i}", address=member_addrs[i],
                peers=list(member_addrs), stats_port=member_stats[i],
                log_dir=os.path.join(base, f"member-{i}"),
                storage=storage, groups=groups, machine=machine))
        for i in range(ingresses):
            spec.ingresses.append(IngressSpec(
                name=f"ingress-{i}", address=ingress_addrs[i],
                members=list(member_addrs), peers=list(ingress_addrs),
                stats_port=ingress_stats[i], groups=groups,
                machine=machine))
        return spec

    # -- views -------------------------------------------------------------

    def children(self) -> list:
        """Every process spec, members first (the tier that must be up
        before an ingress proxy can find a leader)."""
        return [*self.members, *self.ingresses]

    def member_addrs(self) -> list[str]:
        return [m.address for m in self.members]

    def ingress_addrs(self) -> list[str]:
        return [i.address for i in self.ingresses]

    def client_addrs(self) -> list[str]:
        """Where clients should connect: the ingress tier when one is
        deployed, else the members directly (the in-server ingress)."""
        return self.ingress_addrs() or self.member_addrs()

    def stats_addrs(self) -> dict[str, str]:
        """``{child name: stats host:port}`` for the whole topology —
        what per-tier attribution (``bench compartment``), ``copycat-tpu
        doctor`` and the supervisor's health watch scrape."""
        return {c.name: f"{c.address.rsplit(':', 1)[0]}:{c.stats_port}"
                for c in self.children()}

    # -- serialization (the control surface's /topology payload) -----------

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TopologySpec":
        raw = json.loads(text)
        return cls(
            members=[MemberSpec(**m) for m in raw.get("members", ())],
            ingresses=[IngressSpec(**i) for i in raw.get("ingresses", ())],
            groups=raw.get("groups", 1),
            base_dir=raw.get("base_dir"),
            control_port=raw.get("control_port", 0),
        )


def load_machine(spec: str | None):
    """Resolve a ``module:factory`` machine spec to the callable the
    server builds per group; ``None`` resolves to the ResourceManager
    factory (the full resource catalog — what ``copycat-server``
    deploys). Importing the module also registers the machine's op
    types with the serializer, which every process that decodes the
    workload's frames needs."""
    if not spec:
        return None
    module_name, _, attr = spec.partition(":")
    if not module_name or not attr:
        raise ValueError(
            f"bad machine spec {spec!r} — expected module.path:factory")
    import importlib

    module = importlib.import_module(module_name)
    try:
        return getattr(module, attr)
    except AttributeError:
        raise ValueError(
            f"machine spec {spec!r}: {module_name} has no attribute "
            f"{attr!r}") from None
