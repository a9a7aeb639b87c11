"""copycat_tpu_torch — the batched Raft engine in PyTorch, for CUDA.

A second package beside ``copycat_tpu``: the same ``[num_groups,
num_peers]`` consensus engine, written as plain functions on torch
tensors, with the quorum tally as a CUDA kernel written for Hopper
(``csrc/kth_largest.cu``). It imports torch, numpy and the standard
library only; ``copycat_tpu`` stays the reference it is tested against.

- ``ops/kernels.py`` — the k-th-largest quorum tally (CUDA kernel and its
  plain torch version);
- ``ops/apply.py`` — the counter slice of the resource apply kernels;
- ``ops/consensus.py`` — one synchronous Raft round over every group;
- ``models/raft_groups.py`` — the host runtime (submit, step, harvest);
- ``bench.py`` — the counter throughput bench
  (``python -m copycat_tpu_torch.bench``);
- ``convert.py`` — state conversion to and from numpy leaves.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than fall back.
"""

__version__ = "0.1.0"
