"""Fault injection: the device-plane nemesis and the host-plane ones.

Counterpart of ``copycat_tpu/testing/nemesis.py``.

Device plane (:class:`Nemesis`): faults are ``deliver[g, from, to]``
boolean masks that the step applies to every exchange, so partitions and
message loss run at full batch speed. The masks are drawn with numpy
exactly as the reference draws them (same seed and fault sequence, same
masks) and installed as a bool tensor on the engine's device.

Host plane (copies of the reference's): :func:`crash_server`, a
SIGKILL-shaped stop of a ``RaftServer``; :class:`SlowDiskNemesis`, fsync
latency in a server's logs; :class:`LoopHoldNemesis`, a synchronous hold
of the event loop; and :class:`StorageNemesis`, the crash/torn-write
family over a server's storage directory (docs/DURABILITY.md). The first
two record their faults in the device engine's flight recorder when the
server runs one. Torch is imported only where a mask is made: a process
that hosts the counter machine (a deployed child) loads this package
without it.
"""

from __future__ import annotations

import os

import numpy as np

FAULTS = ("heal", "loss", "partition", "isolate")

#: The storage-fault vocabulary of :class:`StorageNemesis` (the host-plane
#: crash/torn-write family, docs/DURABILITY.md).
STORAGE_FAULTS = ("torn_tail", "partial_frame", "dropped_fsync",
                  "corrupt_snapshot", "torn_meta")


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

    def mask(self, fault: str):
        """A fresh draw of ``fault``'s mask on the engine's device (a bool
        tensor)."""
        import torch

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


# ---------------------------------------------------------------------------
# host plane: crash / torn-write faults over a server's storage directory
# ---------------------------------------------------------------------------


async def crash_server(server) -> None:
    """Kill a ``RaftServer`` the way a SIGKILL would: stop its timers,
    replication, and transport WITHOUT the graceful close path — no
    ``log.close()``, no final msync/fsync, pending commit futures
    abandoned.  What recovery then sees on disk is exactly what the
    storage level's durability contract promised and nothing more; pair
    with :class:`StorageNemesis` to tear what the crash left behind."""
    server._closing = True
    server._open = False  # Managed bookkeeping: a crashed server is closed
    server._cancel_timers()
    server._stop_replication()
    for group in getattr(server, "groups", None) or (server,):
        for fut in group._commit_futures.values():
            if not fut.done():
                fut.cancel()
        group._commit_futures.clear()
    await server._server.close()
    await server._client.close()
    server._peer_connections.clear()
    # NOTE: deliberately NOT server.log.close() — buffered/page-cache
    # state stays wherever the fsync policy last left it


class SlowDiskNemesis:
    """Inject fsync latency into a server's log(s): the slow/failing
    disk the health plane's fsync-spike detector (and, via the
    follower's pre-ack fsync, the leader's AIMD window collapse) exists
    to catch. Wraps each group log's ``sync()`` with a blocking sleep —
    blocking on purpose: a real slow fsync stalls the event loop the
    same way."""

    def __init__(self, server, delay_s: float = 0.02) -> None:
        self._server = server
        self.delay_s = delay_s
        self._originals: list[tuple] = []

    def install(self) -> None:
        import time as _time

        for group in getattr(self._server, "groups", None) or (self._server,):
            log = group.log
            original = log.sync

            def slow_sync(_orig=original) -> None:
                _time.sleep(self.delay_s)
                _orig()

            self._originals.append((log, original))
            log.sync = slow_sync  # type: ignore[method-assign]
        hub = self._hub()
        if hub is not None:
            hub.flight.record("fault", 0, fault="slow_disk",
                              delay_s=self.delay_s)

    def remove(self) -> None:
        for log, original in self._originals:
            log.sync = original  # type: ignore[method-assign]
        self._originals.clear()

    def _hub(self):
        machine = getattr(self._server, "state_machine", None)
        engine = getattr(machine, "_engine", None)
        groups = getattr(engine, "_groups", None)
        return getattr(groups, "telemetry", None)


def _nemesis_synchronous_hold(delay_s: float) -> None:
    """The named blocking call :class:`LoopHoldNemesis` schedules — a
    module-level function ON PURPOSE: the profiling plane's ground
    truth is that the folded leaf frame NAMES the blocking code, and a
    lambda/closure would fold to an anonymous frame."""
    import time as _time

    _time.sleep(delay_s)


class LoopHoldNemesis:
    """Inject a synchronous event-loop hold: the blocking-call fault
    the profiling plane's hold attribution and the ``loop_stall``
    detector exist to catch (the runtime sibling of the copycheck
    loop-blocking rule — this one actually happens). Schedules
    :func:`_nemesis_synchronous_hold` straight onto the running loop,
    so every co-resident server's loop freezes for ``delay_s`` — the
    same shape as an accidental ``time.sleep`` / cold kernel build /
    synchronous disk read on the loop."""

    def __init__(self, server, delay_s: float = 0.15) -> None:
        self._server = server
        self.delay_s = delay_s
        self.injected = 0

    def inject(self) -> None:
        """Schedule one hold on the running loop (call from a
        coroutine; the hold lands on the next loop turn)."""
        import asyncio as _asyncio

        _asyncio.get_running_loop().call_soon(
            _nemesis_synchronous_hold, self.delay_s)
        self.injected += 1
        hub = self._hub()
        if hub is not None:
            hub.flight.record("fault", 0, fault="loop_hold",
                              delay_s=self.delay_s)

    def _hub(self):
        machine = getattr(self._server, "state_machine", None)
        engine = getattr(machine, "_engine", None)
        groups = getattr(engine, "_groups", None)
        return getattr(groups, "telemetry", None)


class StorageNemesis:
    """Crash/torn-write fault injection over one server's storage
    directory (the host-plane sibling of :class:`Nemesis`): mutates the
    on-disk artifacts a crashed process leaves behind — log segments,
    snapshot files, the vote-state meta file — the way real torn writes,
    reordered writeback, and lost page-cache flushes do.  Recovery must
    shrug all of it off (tests/test_recovery.py)."""

    def __init__(self, directory: str, seed: int = 0) -> None:
        self.directory = directory
        self._rng = np.random.default_rng(seed)
        self.injected: list[tuple[str, str]] = []  # (fault, path)

    # -- file discovery ----------------------------------------------------

    def _files(self, *exts: str) -> list[str]:
        out = []
        for fname in sorted(os.listdir(self.directory)):
            if fname.endswith(exts):
                out.append(os.path.join(self.directory, fname))
        return out

    def newest_segment(self) -> str | None:
        segs = self._files(".seg", ".mseg")
        return segs[-1] if segs else None

    def newest_snapshot(self) -> str | None:
        snaps = self._files(".snap")
        return snaps[-1] if snaps else None

    def meta_file(self) -> str | None:
        metas = self._files(".meta")
        return metas[0] if metas else None

    def _note(self, fault: str, path: str | None) -> str | None:
        if path is not None:
            self.injected.append((fault, path))
        return path

    # -- the fault family --------------------------------------------------

    @staticmethod
    def _written_end(path: str) -> int:
        """End of the WRITTEN region: mapped segments are sparse with a
        leading watermark (mutating their zero tail would be a no-op), so
        the fault lands at ``header + watermark``; buffered segments are
        written densely to their file size."""
        if path.endswith(".mseg"):
            with open(path, "rb") as f:
                used = int.from_bytes(f.read(8), "little")
            return 8 + used
        return os.path.getsize(path)

    def torn_tail(self, nbytes: int = 11) -> str | None:
        """Chop ``nbytes`` off the newest log segment's written region: a
        write that was mid-flight when the process died."""
        path = self.newest_segment()
        if path is None:
            return None
        # never truncate a mapped segment below its watermark header (an
        # empty file cannot be mmapped back)
        floor = 8 if path.endswith(".mseg") else 0
        with open(path, "r+b") as f:
            f.truncate(max(floor, self._written_end(path) - nbytes))
        return self._note("torn_tail", path)

    def partial_frame(self, nbytes: int = 24) -> str | None:
        """Zero the last ``nbytes`` of the newest segment's written region
        in place: frame header/payload pages that never hit the platter
        even though the file length (or mmap watermark) says they did —
        the reordered-writeback shape the seeded CRC framing exists for."""
        path = self.newest_segment()
        if path is None:
            return None
        end = self._written_end(path)
        with open(path, "r+b") as f:
            f.seek(max(0, end - nbytes))
            f.write(b"\x00" * min(nbytes, end))
        return self._note("partial_frame", path)

    def dropped_fsync(self, frames: int = 1) -> str | None:
        """Rewind the newest DISK segment by its last ``frames``
        length-framed entries — a buffered write the kernel never flushed
        (the ``fsync="never"`` failure mode).  Falls back to
        :meth:`torn_tail` for MAPPED segments (page-cache granularity)."""
        path = self.newest_segment()
        if path is None:
            return None
        if path.endswith(".mseg"):
            return self.torn_tail(64)
        from ..io.buffer import BufferInput
        with open(path, "rb") as f:
            raw = f.read()
        buf = BufferInput(raw)
        ends = []
        while buf.remaining > 0:
            try:
                buf.read_bytes()   # payload
                buf.read_varint()  # trailing frame CRC
            except EOFError:
                break
            ends.append(len(raw) - buf.remaining)
        keep = ends[-1 - frames] if len(ends) > frames else 0
        with open(path, "r+b") as f:
            f.truncate(keep)
        return self._note("dropped_fsync", path)

    def corrupt_snapshot(self, nbytes: int = 16) -> str | None:
        """Flip bytes inside the newest snapshot's payload so its CRC
        frame check fails: recovery must skip it and fall back to an
        older snapshot or full replay, never crash or restore garbage."""
        path = self.newest_snapshot()
        if path is None:
            return None
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            # land inside the payload (past the 20-byte frame header)
            start = int(self._rng.integers(20, max(21, size - nbytes)))
            f.seek(start)
            chunk = f.read(nbytes)
            f.seek(start)
            f.write(bytes(b ^ 0xFF for b in chunk))
        return self._note("corrupt_snapshot", path)

    def torn_meta(self) -> str | None:
        """Truncate the (term, voted_for) meta file mid-write: the torn
        state a non-atomic writer leaves; boot must fall back to
        zero-state instead of dying on a JSON parse error."""
        path = self.meta_file()
        if path is None:
            return None
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return self._note("torn_meta", path)

    def inject(self, fault: str) -> str | None:
        """Inject one named fault from :data:`STORAGE_FAULTS`."""
        if fault not in STORAGE_FAULTS:
            raise ValueError(f"unknown storage fault {fault!r}")
        return getattr(self, fault)()
