"""The ``COPYCAT_*`` environment knobs the port reads, with the
reference's defaults (``copycat_tpu/utils/knobs.py`` declares them all).

Getters read ``os.environ`` live, so a knob set mid-process reaches the
next engine built. Boolean knobs normalize: ``0 / false / off / no /
none`` and the empty string are off, anything else set is on.
"""

from __future__ import annotations

import os

_FALSY = ("", "0", "false", "off", "no", "none")

#: name -> default (None: unset)
DEFAULTS: dict[str, object] = {
    # compile the device telemetry block into engines whose Config left
    # it off
    "COPYCAT_TELEMETRY": False,
    # invariant monitors: observe (count) | strict (raise) | off; setting
    # any mode also turns device telemetry on
    "COPYCAT_INVARIANTS": None,
    # max leaderless-group fraction per fetched round before the monitor
    # trips
    "COPYCAT_INVARIANT_LEADERLESS_MAX": 1.0,
    # 0 removes the sessioned bulk client's edge read cache
    "COPYCAT_EDGE_READS": True,
    # the linearizability verdict (testing/verdict.py): groups in its
    # engine, groups whose histories are checked, rounds under the
    # nemesis, the workload and nemesis seed, rounds between recorded ops
    # of a sampled group, its bounded client concurrency, membership churn
    # during recording, and the deep-plane block (on, its groups, sampled
    # groups and fault epochs)
    "COPYCAT_VERDICT_GROUPS": 10_000,
    "COPYCAT_VERDICT_SAMPLE": 99,
    "COPYCAT_VERDICT_ROUNDS": 1_000,
    "COPYCAT_VERDICT_SEED": 42,
    "COPYCAT_VERDICT_OP_EVERY": 1,
    "COPYCAT_VERDICT_INFLIGHT": 4,
    "COPYCAT_VERDICT_CHURN": True,
    "COPYCAT_VERDICT_DEEP": True,
    "COPYCAT_VERDICT_DEEP_GROUPS": 2_000,
    "COPYCAT_VERDICT_DEEP_SAMPLE": 48,
    "COPYCAT_VERDICT_DEEP_EPOCHS": 40,
}


def _default(name: str):
    try:
        return DEFAULTS[name]
    except KeyError:
        raise KeyError(f"{name} is not a knob the port reads") from None


def get_raw(name: str) -> str | None:
    """The raw value, or ``None`` when unset."""
    _default(name)
    return os.environ.get(name)


def get_str(name: str, default: str | None = None) -> str:
    fallback = default if default is not None else _default(name)
    value = os.environ.get(name)
    if value is None:
        value = fallback
    if value is None:
        raise ValueError(f"{name} has no default; pass default=")
    return str(value)


def get_int(name: str, default: int | None = None) -> int:
    fallback = default if default is not None else _default(name)
    value = os.environ.get(name)
    if value is not None:
        return int(value)
    if fallback is None:
        raise ValueError(f"{name} has no default; pass default=")
    return int(fallback)


def get_float(name: str, default: float | None = None) -> float:
    fallback = default if default is not None else _default(name)
    value = os.environ.get(name)
    if value is not None:
        return float(value)
    value = fallback
    if value is None:
        raise ValueError(f"{name} has no default; pass default=")
    return float(value)


def get_bool(name: str, default: bool | None = None) -> bool:
    fallback = default if default is not None else _default(name)
    value = os.environ.get(name)
    if value is None:
        value = fallback
        if value is None:
            raise ValueError(f"{name} has no default; pass default=")
        return bool(value)
    return value.strip().lower() not in _FALSY
