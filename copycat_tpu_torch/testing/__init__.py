"""Verification harness for the port: linearizability checking and fault
injection on the device plane (counterpart of ``copycat_tpu/testing``).

- :mod:`linearize` — the Wing & Gong checker with sequential models of the
  device resources (a copy of the reference's, so the port stands alone);
- :mod:`nemesis` — fault schedules (partitions, message loss, isolation)
  as ``deliver[g, from, to]`` masks the step applies, and the host-plane
  faults (``crash_server``, slow disks, event-loop holds, storage
  corruption);
- :mod:`counter_machine` — the keyed counter machine the deployment
  plane's children host (``ClusterAdd``/``ClusterGet``, serializer ids
  940/941);
- :mod:`history` — a recorder that drives ``RaftGroups`` with concurrent
  clients and captures invoke/complete windows for the checker;
- :mod:`verdict` — the verdict at bench scale (``python -m
  copycat_tpu_torch.testing.verdict``);
- :mod:`bench_gate` — the perf-regression gate over the bench's
  ``--metrics-json`` artifacts (``python -m
  copycat_tpu_torch.testing.bench_gate A.json --golden G.json``).
"""

from .history import HistoryRecorder  # noqa: F401
from .linearize import (  # noqa: F401
    CounterModel,
    HOp,
    LockModel,
    MapModel,
    RegisterModel,
    check_linearizable,
    check_linearizable_windowed,
    check_map_linearizable,
)
from .nemesis import (  # noqa: F401
    STORAGE_FAULTS,
    LoopHoldNemesis,
    Nemesis,
    SlowDiskNemesis,
    StorageNemesis,
    crash_server,
)
