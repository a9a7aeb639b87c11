"""Checkpoint and restore of a ``RaftGroups`` engine (torch).

Counterpart of ``copycat_tpu/models/checkpoint.py``, in the same format,
so a blob saved by either package loads in the other: one compressed
``.npz`` holding

- ``meta``, a JSON string with every key the reference's ``load`` reads
  (``num_groups``, ``num_peers``, ``log_slots``, ``submit_slots``,
  ``config`` with its ``resource``, ``rounds``, ``clock``, ``next_tag``,
  ``ev_seen``, ``events``, ``key``, ``num_leaves``);
- ``state.<dotted field path>``, one array per state leaf (the reference's
  ``_leaf_name`` paths; ``None`` leaves are not stored);
- ``deliver``, the engine's delivery mask;
- the port's own ``generator_state`` (its ``torch.Generator``), with the
  generator's device type in ``meta``; the reference ignores both.

``key`` is ``[0, seed]``, what the reference's ``PRNGKey(seed)`` holds, so
the reference can rebuild a key from a port blob. A port engine restored
from its own blob on the same device type takes the generator state back
and steps on exactly as the original; from a reference blob (which holds
no torch generator) it seeds its generator from ``key``, and, since the
reference has no ring flow control, it loads with ``ring_flow_control``
off and so steps the reference's step. In-flight client ops are not
saved: clients re-submit, as after a session recovery.

Loading reads leaves by path, so a field absent from the blob takes its
fresh value; a legacy blob of positional ``leaf_<i>`` arrays loads in the
reference's leaf order, which is this package's field order.
"""

from __future__ import annotations

import io
import json
import pathlib

import numpy as np
import torch

from ..device import resolve_device
from ..ops.apply import ResourceConfig
from ..ops.consensus import Config, init_state
from .bulk import stream_count_from_state
from .raft_groups import RaftGroups, fetch


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(dotted field path, leaf)`` of every non-``None`` tensor leaf of a
    NamedTuple tree, in field order (the reference's flatten order)."""
    out = []
    for name, v in tree._asdict().items():
        if isinstance(v, torch.Tensor):
            out.append((prefix + name, v))
        elif v is not None:
            out.extend(_leaf_paths(v, f"{prefix}{name}."))
    return out


def _with_leaves(tree, leaves: dict, prefix: str = ""):
    """``tree`` with the leaves named in ``leaves`` replaced."""
    vals = {}
    for name, v in tree._asdict().items():
        if isinstance(v, torch.Tensor):
            vals[name] = leaves.get(prefix + name, v)
        elif v is not None:
            vals[name] = _with_leaves(v, leaves, f"{prefix}{name}.")
        else:
            vals[name] = None
    return type(tree)(**vals)


def save(rg: RaftGroups, path) -> None:
    """Snapshot ``rg`` to ``path`` (a file name or a writable file).

    The state leaves and the delivery mask come off the device in one
    copy."""
    paths = _leaf_paths(rg.state)
    arrays_np = fetch([x for _, x in paths] + [rg.deliver])
    arrays = {f"state.{name}": a for (name, _), a in zip(paths, arrays_np)}
    arrays["deliver"] = arrays_np[-1]
    arrays["generator_state"] = rg.generator.get_state().numpy()
    meta = {
        "num_groups": rg.num_groups,
        "num_peers": rg.num_peers,
        "log_slots": rg.log_slots,
        "submit_slots": rg.submit_slots,
        "config": rg.config._asdict() | {
            "resource": rg.config.resource._asdict()},
        "rounds": rg.rounds,
        "clock": rg.clock,
        "next_tag": rg._next_tag,
        "ev_seen": rg._ev_seen,
        # the host event buffer, consumed events included (facades keep
        # their own cursors)
        "events": {str(g): evs for g, evs in rg.events.items()},
        "key": list(rg.key),
        "num_leaves": len(paths),
        "generator_device": rg.generator.device.type,
    }
    target = path if hasattr(path, "write") else str(path)
    np.savez_compressed(target, meta=json.dumps(meta), **arrays)


def save_bytes(rg: RaftGroups) -> bytes:
    """:func:`save` into in-memory bytes (the same format)."""
    bio = io.BytesIO()
    save(rg, bio)
    return bio.getvalue()


def load_bytes(data: bytes, device: torch.device | str | None = None
               ) -> RaftGroups:
    """Restore an engine from :func:`save_bytes` output (or the
    reference's)."""
    return load(io.BytesIO(data), device=device)


def _config_from(meta: dict) -> Config:
    cfg = dict(meta["config"])
    cfg["resource"] = ResourceConfig(**cfg["resource"])
    # a reference blob: no flow control (its step has none), and fields
    # this package has not (use_pallas) dropped
    cfg.setdefault("ring_flow_control", False)
    cfg = {k: v for k, v in cfg.items() if k in Config._fields}
    if isinstance(cfg.get("pool_budgets"), list):
        cfg["pool_budgets"] = tuple(cfg["pool_budgets"])
    return Config(**cfg)


def load(path: str | pathlib.Path, device: torch.device | str | None = None
         ) -> RaftGroups:
    """Restore an engine from a snapshot of either package, on ``device``
    (``cuda`` unless another is named)."""
    source = path if hasattr(path, "read") else str(path)
    dev = resolve_device(device)
    with np.load(source, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        key = tuple(int(k) for k in meta["key"])
        config = _config_from(meta)
        G, P, L = meta["num_groups"], meta["num_peers"], meta["log_slots"]
        # one group's fresh state: the leaves' paths, dtypes and trailing
        # shapes, and the value of a leaf the blob does not hold
        fresh = init_state(1, P, L, torch.zeros((1, P), dtype=torch.int32,
                                                device=dev), config)
        paths = _leaf_paths(fresh)
        if any(k.startswith("state.") for k in data.files):
            found = {name: data[f"state.{name}"] for name, _ in paths
                     if f"state.{name}" in data.files}
        else:
            # legacy positional leaf_0..leaf_N, in the saving code's field
            # order; fields were only ever appended while it was in use
            found = {name: data[f"leaf_{i}"] for i, (name, _) in
                     enumerate(paths[:meta["num_leaves"]])}
        state = _with_leaves(fresh, {
            name: torch.from_numpy(np.ascontiguousarray(found[name])).to(
                dev, x.dtype) if name in found
            else x.expand(G, *x.shape[1:]).clone() for name, x in paths})
        rg = RaftGroups(G, P, log_slots=L, submit_slots=meta["submit_slots"],
                        config=config, seed=(key[0] << 32) | key[1],
                        device=dev, state=state)
        rg.deliver = torch.from_numpy(np.asarray(data["deliver"])).to(dev)
        if meta.get("generator_device") == dev.type \
                and "generator_state" in data.files:
            rg.generator.set_state(torch.from_numpy(
                np.array(data["generator_state"])))
    rg.key = key
    rg.rounds = meta["rounds"]
    rg.clock = meta["clock"]
    rg._next_tag = meta["next_tag"]
    rg._ev_seen = {int(k): int(v) for k, v in meta["ev_seen"].items()}
    rg.events = {int(g): [tuple(e) for e in evs]
                 for g, evs in meta.get("events", {}).items()}
    if rg.config.monotone_tag_accept:
        # the monotone stream cursor is derived from the restored ring, not
        # stored (blobs from before the cursor existed restore it too)
        rg._stream_count = stream_count_from_state(rg.state,
                                                   fetch=rg._fetch_acc)
    return rg
