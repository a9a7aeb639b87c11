"""The port's graft entry: the flagship function with example arguments.

The counterpart of the reference's ``__graft_entry__.py``. :func:`entry`
returns ``(fn, args)``: ``fn`` is the batched Raft consensus step
(``ops/consensus.py::step`` at the default ``Config()``) and ``args`` its
inputs at the reference's shapes — G=256 groups × P=3 peers, L=32 log
slots, S=4 submit slots: a fresh state, empty submits, full delivery, and
the two election-timer draws (``fresh``, ``cand``) the reference's step
makes from its key inside, drawn here from a seeded ``torch.Generator``.
One call launches each fused quorum kernel of ``csrc/quorum_phase.cu``
once (``admit_submits``, then ``ack_commit``) on the card; on the CPU it
runs their plain versions.

    python -m copycat_tpu_torch.graft_entry

runs ``fn(*args)`` once on the card and prints ``entry: ok``; it probes
the card first (``utils/platform.require_devices`` under
``COPYCAT_ENTRY_DEVICE_TIMEOUT``) and exits 2 when none answers.

The reference's ``dryrun_multichip`` (the step sharded over a device mesh)
has no counterpart yet: it needs the port's multi-device plane, the last
of the modules still missing (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from functools import partial

import torch

from .device import resolve_device
from .ops.consensus import (
    Config,
    draw_timers,
    full_delivery,
    init_state,
    make_submits,
    step,
)

#: The reference's entry shapes (``__graft_entry__.py``).
NUM_GROUPS, NUM_PEERS, LOG_SLOTS, SUBMIT_SLOTS = 256, 3, 32, 4
SEED = 0


def entry(device=None):
    """Return ``(fn, args)``: ``fn(*args)`` is one consensus round over
    every group. ``args`` are ``(state, submits, deliver, fresh, cand)``
    on ``device`` — ``cuda`` unless the caller names another; without a
    card it raises."""
    dev = resolve_device(device)
    config = Config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    G, P = NUM_GROUPS, NUM_PEERS
    state = init_state(G, P, LOG_SLOTS, draw_timers(G, P, config, gen),
                       config)
    submits = make_submits(G, SUBMIT_SLOTS, dev)
    deliver = full_delivery(G, P, dev)
    fresh = draw_timers(G, P, config, gen)
    cand = draw_timers(G, P, config, gen)
    return partial(step, config=config), (state, submits, deliver, fresh,
                                          cand)


def main() -> int:
    from .utils.platform import require_devices

    require_devices(env="COPYCAT_ENTRY_DEVICE_TIMEOUT", default_probes=2)
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    print("entry: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
