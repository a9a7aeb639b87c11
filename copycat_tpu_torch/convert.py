"""Carry engine state between ``copycat_tpu`` and this package.

The reference's ``RaftState`` / ``Submits`` / ``StepOutputs`` / ``Config``
arrive as NamedTuples whose leaves convert with ``numpy.asarray``, or as
plain dicts keyed by field name; the ``*_to_torch`` functions build this
package's types from them on a chosen device, and :func:`to_numpy` turns
any of this package's NamedTuples into nested dicts of numpy arrays by
field name. The field names and dtypes are the reference's, so the two
engines can start from one state and be compared leaf by leaf — the
voter bitmask ``member`` (set from ``voters`` / ``members`` at init), the
``refused`` output of dynamic membership and the ``telemetry`` block
(:class:`DeviceTelemetry`) included. The deep drive's accumulators
(``resbuf``, ``valbuf``, ``rndbuf``, ``evflag``) cross with
:func:`deep_to_torch` and, as a dict by those names, compare with
:func:`flat_leaves`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .ops.apply import ResourceConfig, ResourceState
from .ops.consensus import (
    Config,
    DeviceTelemetry,
    RaftState,
    StepOutputs,
    Submits,
)

DEEP_ACCUMULATORS = ("resbuf", "valbuf", "rndbuf", "evflag")


def _fields(x: Any) -> dict:
    if isinstance(x, dict):
        return x
    if hasattr(x, "_asdict"):
        return x._asdict()
    raise TypeError(f"expected a NamedTuple or a dict, got {type(x).__name__}")


def _leaf(v: Any, device: torch.device | str) -> Any:
    if v is None:
        return None
    return torch.from_numpy(np.array(v)).to(device)


def _build(cls, x: Any, device, nested: dict | None = None):
    f = _fields(x)
    missing = [n for n in cls._fields if n not in f and
               n not in cls._field_defaults]
    if missing:
        raise ValueError(f"{cls.__name__}: missing fields {missing}")
    nested = nested or {}
    out = {}
    for name in cls._fields:
        if name not in f:
            continue
        sub = nested.get(name)
        out[name] = (_build(sub, f[name], device)
                     if sub is not None and f[name] is not None
                     else _leaf(f[name], device))
    return cls(**out)


def state_to_torch(state: Any, device: torch.device | str) -> RaftState:
    return _build(RaftState, state, device, {"resources": ResourceState})


def resources_to_torch(res: Any, device: torch.device | str
                       ) -> ResourceState:
    return _build(ResourceState, res, device)


def submits_to_torch(submits: Any, device: torch.device | str) -> Submits:
    return _build(Submits, submits, device)


def outputs_to_torch(outputs: Any, device: torch.device | str) -> StepOutputs:
    return _build(StepOutputs, outputs, device,
                  {"telemetry": DeviceTelemetry})


def deep_to_torch(acc: Any, device: torch.device | str) -> tuple:
    """The deep accumulators ``(resbuf, valbuf, rndbuf, evflag)`` from a
    sequence in that order or a dict by those names."""
    if isinstance(acc, dict):
        acc = [acc[name] for name in DEEP_ACCUMULATORS]
    if len(acc) != len(DEEP_ACCUMULATORS):
        raise ValueError(f"expected {DEEP_ACCUMULATORS}, got {len(acc)} "
                         "arrays")
    return tuple(_leaf(x, device) for x in acc)


def config_to_torch(config: Any) -> Config:
    """This package's ``Config`` that steps exactly as the reference's
    does: ``use_pallas`` is dropped (the device of the state chooses the
    tally) and ``ring_flow_control`` is off, as the reference has none.
    Every other field, ``dynamic_membership`` included, passes as it
    is."""
    f = dict(_fields(config))
    f.pop("use_pallas", None)
    f.setdefault("ring_flow_control", False)
    if "resource" in f:
        f["resource"] = ResourceConfig(**_fields(f["resource"]))
    return Config(**f)


def flat_leaves(x: Any, prefix: str = "") -> dict[str, Any]:
    """Every leaf of a NamedTuple or dict (nested ones too) as a numpy
    array keyed by dotted field name (``resources.value``); ``None`` leaves
    stay ``None``. Takes either package's types, so two states compare
    leaf by leaf."""
    out: dict[str, Any] = {}
    for name, v in _fields(x).items():
        if isinstance(v, dict) or hasattr(v, "_asdict"):
            out.update(flat_leaves(v, f"{prefix}{name}."))
        elif v is None:
            out[prefix + name] = None
        elif isinstance(v, torch.Tensor):
            out[prefix + name] = v.detach().cpu().numpy()
        else:
            out[prefix + name] = np.asarray(v)
    return out


def to_numpy(x: Any) -> Any:
    """A NamedTuple of tensors (nested ones too) as a dict of numpy arrays
    by field name; a tensor as a numpy array."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_asdict"):
        return {k: to_numpy(v) for k, v in x._asdict().items()}
    return x
