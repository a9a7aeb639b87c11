"""Compartmentalized deployment plane (docs/DEPLOYMENT.md).

The subsystem that turns the in-process cluster into a deployable,
supervisable topology: a :class:`~copycat_tpu_torch.deploy.topology.TopologySpec`
describes members × groups × an optional standalone ingress/proxy tier
(ports, log dirs, stats ports); the
:class:`~copycat_tpu_torch.deploy.supervisor.Supervisor` launches one OS
process per role over real sockets and real fsync, watches each child's
``/healthz``, restarts crashes with backoff, and tears the cluster down
cleanly. :class:`~copycat_tpu_torch.deploy.ingress.IngressServer` is the new
role: a wire-facing process that owns client connections and the global
ingress batching the server plane used to do in-process, forwarding
sealed sub-blocks to group leaders — scaled out independently of write
quorums per "Scaling Replicated State Machines with
Compartmentalization" (PAPERS.md).
"""

from .ingress import IngressServer
from .supervisor import Supervisor
from .topology import (
    IngressSpec,
    MemberSpec,
    TopologySpec,
    allocate_ports,
)

__all__ = [
    "IngressServer",
    "IngressSpec",
    "MemberSpec",
    "Supervisor",
    "TopologySpec",
    "allocate_ports",
]
