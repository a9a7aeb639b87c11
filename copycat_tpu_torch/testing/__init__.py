"""Verification harness for the port: linearizability checking and fault
injection on the device plane (counterpart of ``copycat_tpu/testing``).

- :mod:`linearize` — the Wing & Gong checker with sequential models of the
  device resources (a copy of the reference's, so the port stands alone);
- :mod:`nemesis` — fault schedules (partitions, message loss, isolation)
  as ``deliver[g, from, to]`` masks the step applies;
- :mod:`history` — a recorder that drives ``RaftGroups`` with concurrent
  clients and captures invoke/complete windows for the checker;
- :mod:`verdict` — the verdict at bench scale (``python -m
  copycat_tpu_torch.testing.verdict``).
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
from .nemesis import Nemesis  # noqa: F401
