"""Fault injection on the device plane: the nemesis.

Counterpart of ``copycat_tpu/testing/nemesis.py``'s :class:`Nemesis`.
Faults are ``deliver[g, from, to]`` boolean masks that the step applies to
every exchange, so partitions and message loss run at full batch speed.
The masks are drawn with numpy exactly as the reference draws them (same
seed and fault sequence, same masks) and installed as a bool tensor on
the engine's device. The host-plane faults (slow disks, loop holds,
storage corruption, server crashes) belong to the server plane, which the
port does not have yet.
"""

from __future__ import annotations

import numpy as np
import torch

FAULTS = ("heal", "loss", "partition", "isolate")


class Nemesis:
    """Random fault schedule over a ``RaftGroups`` batch.

    Call :meth:`tick` once per driver round; every ``period`` rounds it
    re-rolls a fault and installs the deliver mask. ``heal()`` restores
    full connectivity (call before asserting convergence).
    """

    def __init__(self, rg, seed: int = 0, period: int = 10,
                 faults: tuple = FAULTS, drop_p: float = 0.3) -> None:
        self._rg = rg
        self._rng = np.random.default_rng(seed)
        self._period = max(1, period)
        self._faults = faults
        self._drop_p = drop_p
        self._rounds = 0
        self.current = "heal"

    def _mask(self, fault: str) -> np.ndarray:
        G = self._rg.num_groups
        P = self._rg.num_peers
        if fault == "heal":
            return np.ones((G, P, P), bool)
        if fault == "loss":
            return self._rng.random((G, P, P)) > self._drop_p
        if fault == "partition":
            side = self._rng.integers(0, 2, (G, P))
            return side[:, :, None] == side[:, None, :]
        if fault == "isolate":
            victim = self._rng.integers(0, P, G)
            mask = np.ones((G, P, P), bool)
            g = np.arange(G)
            mask[g, victim, :] = False
            mask[g, :, victim] = False
            return mask
        raise ValueError(f"unknown fault {fault!r}")

    def mask(self, fault: str) -> torch.Tensor:
        """A fresh draw of ``fault``'s mask on the engine's device."""
        return torch.from_numpy(self._mask(fault)).to(self._rg.device)

    def tick(self) -> str:
        """Advance the schedule; installs a fresh fault every period."""
        if self._rounds % self._period == 0:
            self.current = str(self._rng.choice(self._faults))
            self._install(self.current)
        self._rounds += 1
        return self.current

    def heal(self) -> None:
        self.current = "heal"
        self._install("heal")

    def _install(self, fault: str) -> None:
        self._rg.deliver = self.mask(fault)
        # the injected fault lands in the same bounded ring as the device
        # telemetry, so an election spike sits next to the partition that
        # caused it
        hub = getattr(self._rg, "telemetry", None)
        if hub is not None:
            hub.flight.record("fault", self._rg.rounds, fault=fault)
