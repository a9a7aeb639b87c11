"""copycat_tpu_torch — the batched Raft engine in PyTorch, for CUDA.

A second package beside ``copycat_tpu``: the same ``[num_groups,
num_peers]`` consensus engine, written as plain functions on torch
tensors, with the quorum tally and the step phases around it as CUDA
kernels written for Hopper (``csrc/``). It imports torch, numpy and the
standard library only; ``copycat_tpu`` stays the reference it is tested
against.

- ``ops/kernels.py`` — the quorum kernels (the k-th-largest tally, and
  the fused phase-1 admission and phase-3 commit of ``step``) and their
  plain torch versions;
- ``ops/apply.py`` — the resource apply kernels of every pool, one entry
  at a time (``apply_entry``) or folded per pool (``apply_window``);
- ``ops/consensus.py`` — one synchronous Raft round over every group
  (static or dynamic membership), and the read-only ``query_step``;
- ``models/raft_groups.py`` — the host runtime (submit, step, harvest,
  the query lane, vector drives, membership changes);
- ``models/sessions.py`` — device sessions: keep-alives and expiry
  fan-out through the log;
- ``bench.py`` — the bench of the counter, map, lock, mixed, election and
  map_read scenarios (``python -m copycat_tpu_torch.bench --scenario
  ...``);
- ``convert.py`` — state conversion to and from numpy leaves;
- ``cases.py`` — random inputs, with edge cases, for the fused kernels'
  tests.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than fall back.
"""

__version__ = "0.1.0"
