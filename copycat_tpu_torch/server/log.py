"""The replicated log: entries, segmented storage, incremental cleaning.

The reference's storage contract (SURVEY.md §5.4): no snapshots — live state is
*retained commits*; every applied commit must eventually be ``clean()``ed
(effect superseded; entry reclaimable) and compaction drops cleaned entries.
``Storage(StorageLevel.MEMORY|MAPPED|DISK, max_entries_per_segment, ...)``
mirrors the reference builder surface (``withMaxEntriesPerSegment(16)`` in
``StandaloneServerExample.java``).

The TPU engine's equivalent of this file is a fixed-capacity ring + liveness
bitmap per group (``copycat_tpu_torch.ops.logring``); this CPU log is the oracle.
"""

from __future__ import annotations

import enum
import json
import logging
import mmap
import os
import zlib
from typing import Any, Iterator

from ..io.buffer import BufferInput, BufferOutput
from ..io.serializer import Serializer, serialize_with
from ..utils.fields import compile_field_init


class StorageLevel(enum.Enum):
    MEMORY = "memory"
    MAPPED = "mapped"  # mmap-backed segments (page-cache writes, no syscalls)
    DISK = "disk"      # buffered files, flushed (not fsynced) per append


#: Valid ``Storage.fsync`` policies (docs/DURABILITY.md):
#: - "never":  buffered flush per append only; data reaches the disk at the
#:   OS's leisure (or at ``close()``). Survives process crash, not power loss.
#: - "commit": ``Log.sync()`` fsyncs/msyncs at every point an entry becomes
#:   part of the commit contract — when the server's commit index advances,
#:   on followers BEFORE a success AppendResponse (the leader counts that
#:   ack toward quorum commit; an un-fsynced ack could let a cluster-wide
#:   power loss erase an acknowledged commit), and at segment-roll
#:   boundaries — the default: committed (acknowledged) entries are
#:   power-loss durable, uncommitted tail entries may be torn (which Raft
#:   recovery tolerates by construction).
#: - "always": fsync/msync per appended entry. Strongest and slowest.
FSYNC_POLICIES = ("never", "commit", "always")


class Storage:
    """Log storage configuration (reference ``Storage`` builder equivalent).

    Actual durability of each level (measured against a process crash /
    a power loss, with the default ``fsync="commit"`` policy):

    ============ ======================= ==================================
    level        process crash           power loss / kernel crash
    ============ ======================= ==================================
    ``MEMORY``   lost (no files)         lost
    ``MAPPED``   safe (page cache)       committed prefix safe after
                                         ``sync()``; torn tail dropped by
                                         the per-frame seeded CRC
    ``DISK``     safe (flushed)          committed prefix safe after
                                         ``sync()``; torn tail dropped by
                                         the length-framed replay walk
    ============ ======================= ==================================

    ``fsync="never"`` downgrades the power-loss column to "lost since the
    last roll/close"; ``fsync="always"`` upgrades it to per-entry at the
    cost of one fsync/msync per append.
    """

    def __init__(
        self,
        level: StorageLevel = StorageLevel.MEMORY,
        directory: str | None = None,
        max_entries_per_segment: int = 1024,
        compaction_threshold: float = 0.5,
        fsync: str = "commit",
    ) -> None:
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync must be one of {FSYNC_POLICIES}, got {fsync!r}")
        self.level = level
        self.directory = directory
        self.max_entries_per_segment = max_entries_per_segment
        self.compaction_threshold = compaction_threshold
        self.fsync = fsync

    def build_log(self, name: str = "log") -> "Log":
        return Log(self, name)


class _MappedSegment:
    """One mmap-backed log segment: ``[u64 watermark][frames...]``.

    The MAPPED level of the reference Storage contract: appends are memory
    copies into the OS page cache through the mapping — no write/flush
    syscall per entry (DISK pays both).  Durability is page-cache-deep until
    ``close()`` (which msyncs).  Kernel writeback order between the
    watermark page and frame pages is unspecified, so the watermark alone
    cannot bound a torn tail; each frame therefore carries
    ``[u32 len][u32 crc32]`` and recovery stops at the first frame whose
    checksum fails — everything before it is intact by construction.
    """

    HEADER = 8
    FRAME_HEADER = 8  # u32 payload length + u32 crc32
    #: Nonzero CRC seed: crc32(b"") == 0, so with a zero seed an all-zero
    #: torn frame (header page never written back) would VALIDATE as an
    #: empty frame. Seeding makes all-zero bytes fail the check.
    #: The seed also doubles as the entry WIRE-FORMAT version stamp: bump
    #: it whenever serialized entry bytes OR the segment framing change
    #: shape (last: the trailing per-frame CRC added to DISK segments —
    #: shared seed, so pre-CRC .seg files fail the check at their first
    #: frame instead of misparsing the next frame's length as a CRC), so
    #: segments written by an older format fail CRC cleanly at frame 0
    #: and recover as empty instead of misparsing old bytes into wrong
    #: entries.
    CRC_SEED = 0xA5C6

    def __init__(self, path: str, capacity: int) -> None:
        # Exclusive create: segments are named by the entry index that
        # triggered the roll, so an unexpected name collision must fail
        # loudly instead of silently truncating persisted frames (the DISK
        # path is immune via "ab"; this keeps MAPPED equally safe).
        self._f = open(path, "x+b")
        self._f.truncate(self.HEADER + capacity)
        self._mm = mmap.mmap(self._f.fileno(), 0)
        self._used = 0

    @classmethod
    def reopen(cls, path: str) -> "_MappedSegment":
        """Reopen an existing segment for continued appends after recovery:
        the write position resumes after the last CRC-valid frame and the
        watermark is re-clamped to it.

        The region between the resume point and the old watermark is
        ZEROED AND FLUSHED before any append: it may still hold CRC-valid
        stale frames (e.g. a torn tail the recovery discarded), and a later
        crash whose writeback persisted an advanced watermark but not the
        new frame bytes would otherwise resurrect them as a log prefix
        that never existed (the same writeback-reordering class the CRC
        framing defends against)."""
        seg = cls.__new__(cls)
        seg._f = open(path, "r+b")
        seg._mm = mmap.mmap(seg._f.fileno(), 0)
        old_mark = int.from_bytes(seg._mm[:cls.HEADER], "little")
        used = 0
        for payload in cls.read_payloads(path):
            used += cls.FRAME_HEADER + len(payload)
        seg._used = used
        seg._mm[:cls.HEADER] = used.to_bytes(cls.HEADER, "little")
        stale_end = min(cls.HEADER + old_mark, len(seg._mm))
        if stale_end > cls.HEADER + used:
            seg._mm[cls.HEADER + used:stale_end] = bytes(
                stale_end - cls.HEADER - used)
        seg._mm.flush()  # stale bytes must be gone before any new frame
        return seg

    def append(self, payload: bytes) -> bool:
        """Copy a frame in; False when it doesn't fit (caller rolls over)."""
        start = self.HEADER + self._used
        total = self.FRAME_HEADER + len(payload)
        if start + total > len(self._mm):
            return False
        header = (len(payload).to_bytes(4, "little")
                  + zlib.crc32(payload, self.CRC_SEED).to_bytes(4, "little"))
        self._mm[start:start + total] = header + payload
        self._used += total
        self._mm[:self.HEADER] = self._used.to_bytes(self.HEADER, "little")
        return True

    def flush(self) -> None:
        """msync the mapping: everything appended so far is power-loss
        durable (the MAPPED half of the ``fsync`` policy)."""
        self._mm.flush()

    def close(self) -> None:
        self._mm.flush()
        self._mm.close()
        self._f.close()

    @staticmethod
    def read_payloads(path: str) -> list[bytes]:
        """CRC-valid frame payloads of a closed/crashed segment, stopping
        at the first torn frame (watermark- and checksum-bounded)."""
        return _MappedSegment.read_payloads_ex(path)[0]

    @staticmethod
    def read_payloads_ex(path: str) -> tuple[list[bytes], bool]:
        """``(payloads, torn)``: the CRC-valid frame payloads plus whether
        the walk stopped BEFORE the watermark (a torn frame inside the
        written region — recovery must then distrust everything after
        this segment, not just this segment's tail)."""
        with open(path, "rb") as f:
            used = int.from_bytes(f.read(_MappedSegment.HEADER), "little")
            data = f.read(used)
        payloads = []
        pos = 0
        torn = len(data) < used
        while pos + _MappedSegment.FRAME_HEADER <= len(data):
            length = int.from_bytes(data[pos:pos + 4], "little")
            crc = int.from_bytes(data[pos + 4:pos + 8], "little")
            payload = data[pos + 8:pos + 8 + length]
            # The seeded CRC alone separates "torn" from "empty":
            # crc32(b"", CRC_SEED) != 0, so an all-zero torn frame fails
            # while a legitimately zero-length payload still validates.
            if (len(payload) < length
                    or zlib.crc32(payload, _MappedSegment.CRC_SEED) != crc):
                torn = True
                break  # torn tail: everything before it is intact
            payloads.append(payload)
            pos += _MappedSegment.FRAME_HEADER + length
        return payloads, torn or pos < used


class Entry(object):
    """Base log entry. ``index`` is assigned on append; ``timestamp`` is the
    leader's clock at append time and drives all deterministic timers."""

    _fields: tuple[str, ...] = ()

    def __init__(self, term: int = 0, timestamp: float = 0.0, **kwargs: Any) -> None:
        self.index = 0
        self.term = term
        self.timestamp = timestamp
        for name in self._fields:
            setattr(self, name, kwargs.get(name))

    def __init_subclass__(cls, **kwargs: Any) -> None:
        # Compiled per-class __init__ (same treatment as protocol
        # messages): CommandEntry construction is per-op on the leader's
        # append path, where the generic kwargs loop was measurable.
        super().__init_subclass__(**kwargs)
        fields = cls.__dict__.get("_fields")
        if fields is None or "__init__" in cls.__dict__:
            return
        compile_field_init(cls, fields,
                           head=", term=0, timestamp=0.0",
                           body_head="    self.index = 0\n"
                                     "    self.term = term\n"
                                     "    self.timestamp = timestamp\n")

    def write_object(self, buf: BufferOutput, serializer: Serializer) -> None:
        buf.write_i64(self.index)
        buf.write_i64(self.term)
        buf.write_f64(self.timestamp)
        for name in self._fields:
            serializer.write_object(getattr(self, name), buf)

    def read_object(self, buf: BufferInput, serializer: Serializer) -> None:
        self.index = buf.read_i64()
        self.term = buf.read_i64()
        self.timestamp = buf.read_f64()
        for name in self._fields:
            setattr(self, name, serializer.read_object(buf))

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._fields)
        return f"{type(self).__name__}(i={self.index}, t={self.term}{', ' if inner else ''}{inner})"


@serialize_with(230)
class NoOpEntry(Entry):
    """Appended by a new leader to commit entries from prior terms and to
    advance the deterministic state-machine clock (drives log-time timers)."""


@serialize_with(231)
class RegisterEntry(Entry):
    # session_id: None on the single-group plane (the id IS the entry's
    # log index, the reference rule). On a multi-group server the
    # id-allocating group 0 leaves it None and derives the global id at
    # apply; the fan-out entries appended to groups 1..G-1 carry that id
    # explicitly so every group's replica shares it (docs/SHARDING.md).
    _fields = ("client_id", "timeout", "session_id")


@serialize_with(232)
class KeepAliveEntry(Entry):
    _fields = ("session_id", "command_seq", "event_index")


@serialize_with(233)
class UnregisterEntry(Entry):
    # expired=True when appended by the leader's session-timeout detector;
    # False for a graceful client unregister.
    _fields = ("session_id", "expired")


@serialize_with(234)
class CommandEntry(Entry):
    _fields = ("session_id", "seq", "operation")


@serialize_with(235)
class ConfigurationEntry(Entry):
    _fields = ("members",)


class Log:
    """Append-ordered entry store with incremental cleaning.

    In-memory list with a base offset; DISK/MAPPED levels additionally append
    serialized entries to segment files and recover by replay on open.
    ``clean(index)`` marks an entry's effect superseded; ``compact()`` nulls
    cleaned entries that every server has applied (they are never sent again),
    freeing memory while preserving indices.

    ``truncate_prefix(index)`` actually RELEASES the prefix behind a
    state-machine snapshot (docs/DURABILITY.md): entries ``<= index`` are
    dropped, fully-covered segment files are deleted, and
    ``(prefix_index, prefix_term)`` is persisted in an atomic marker file so
    recovery replays only the surviving tail.  ``term_at(prefix_index)``
    keeps answering from the marker — AppendEntries consistency checks and
    vote up-to-date comparisons still work at the truncation boundary.
    """

    def __init__(self, storage: Storage, name: str = "log") -> None:
        self._storage = storage
        self._name = name
        self._entries: list[Entry | None] = []
        self._offset = 1  # index of _entries[0]
        # last index released by prefix truncation (0 = none) and its term;
        # everything <= _prefix_index lives only in the snapshot now.
        self._prefix_index = 0
        self._prefix_term = 0
        self._cleaned: set[int] = set()
        # (start_index, term) for each term change — lets term_at() answer for
        # compacted (None) slots, which matters for AppendEntries prev-term
        # checks and vote up-to-date comparisons after compaction.
        self._term_starts: list[tuple[int, int]] = []
        self._serializer = Serializer()
        self._segment_file = None          # DISK: buffered append file
        self._mapped: _MappedSegment | None = None  # MAPPED: mmap segment
        self._segment_count = 0
        if storage.level in (StorageLevel.DISK, StorageLevel.MAPPED):
            assert storage.directory, "DISK/MAPPED storage requires a directory"
            os.makedirs(storage.directory, exist_ok=True)
            self._recover()

    # -- append/read -------------------------------------------------------

    @property
    def first_index(self) -> int:
        return self._offset

    @property
    def prefix_index(self) -> int:
        """Last index released by prefix truncation (0 = nothing released).
        A follower whose ``next_index`` falls at or below this cannot be
        served from the log — it needs a snapshot install."""
        return self._prefix_index

    @property
    def prefix_term(self) -> int:
        return self._prefix_term

    @property
    def last_index(self) -> int:
        return self._offset + len(self._entries) - 1

    @property
    def empty(self) -> bool:
        return not self._entries

    def _note_term(self, index: int, term: int) -> None:
        if not self._term_starts or self._term_starts[-1][1] != term:
            if not self._term_starts or self._term_starts[-1][0] < index:
                self._term_starts.append((index, term))

    def append(self, entry: Entry) -> int:
        entry.index = self.last_index + 1
        self._entries.append(entry)
        self._note_term(entry.index, entry.term)
        if self._segment_dir is not None:
            self._persist(entry)
        return entry.index

    def append_block(self, entries: list[Entry]) -> int:
        """Append a run of same-term stamped entries with one index walk
        (the leader's batched command staging); returns the last index."""
        if not entries:
            return self.last_index
        index = self.last_index
        store = self._entries
        for entry in entries:
            index += 1
            entry.index = index
            store.append(entry)
        self._note_term(entries[0].index, entries[0].term)
        if self._segment_dir is not None:
            for entry in entries:
                self._persist(entry)
        return index

    def append_replicated(self, entry: Entry) -> None:
        """Append an entry at its replicated index, gap-filling compacted
        slots with None (a leader may legitimately skip cleaned+compacted
        entries when replicating — their effects are superseded by design)."""
        assert entry.index > self.last_index, f"{entry.index} <= {self.last_index}"
        while self.last_index + 1 < entry.index:
            self._entries.append(None)
        self._entries.append(entry)
        self._note_term(entry.index, entry.term)
        if self._segment_dir is not None:
            self._persist(entry)

    def append_replicated_block(self, entries: list[Entry]) -> None:
        """Append a run of replicated entries past ``last_index`` in one
        walk — the follower's mirror of the leader's ``append_block``.

        Gap-fills compacted slots between entries (same contract as
        ``append_replicated``), notes term boundaries once per term
        change instead of per entry, and persists the whole block after
        the in-memory walk. Entries must arrive in increasing index
        order starting past the current tail (the shape one
        AppendRequest window has after the conflict scan)."""
        if not entries:
            return
        assert entries[0].index > self.last_index, \
            f"{entries[0].index} <= {self.last_index}"
        store = self._entries
        index = self.last_index
        term = self._term_starts[-1][1] if self._term_starts else None
        for entry in entries:
            while index + 1 < entry.index:
                store.append(None)
                index += 1
            store.append(entry)
            index += 1
            if entry.term != term:
                self._note_term(entry.index, entry.term)
                term = entry.term
        if self._segment_dir is not None:
            for entry in entries:
                self._persist(entry)

    def fill_gap(self, to_index: int) -> None:
        """Extend the log with empty (compacted-elsewhere) slots up to to_index."""
        while self.last_index < to_index:
            self._entries.append(None)

    def set_slot(self, entry: Entry) -> None:
        """Place an entry into a previously gap-filled (None) slot."""
        slot = entry.index - self._offset
        if 0 <= slot < len(self._entries) and self._entries[slot] is None:
            self._entries[slot] = entry
            if self._segment_dir is not None:
                self._persist(entry)

    def get(self, index: int) -> Entry | None:
        if index < self._offset or index > self.last_index:
            return None
        return self._entries[index - self._offset]

    def entries_from(self, index: int, limit: int = 64) -> list[Entry]:
        """Entries [index, index+limit) for replication. Compacted (None) slots
        are skipped — they are only compacted once all members applied them."""
        out = []
        for i in range(max(index, self._offset), min(index + limit, self.last_index + 1)):
            entry = self._entries[i - self._offset]
            if entry is not None:
                out.append(entry)
        return out

    def truncate(self, from_index: int) -> None:
        """Remove entries >= from_index (conflict resolution on followers)."""
        if from_index <= self.last_index:
            keep = max(0, from_index - self._offset)
            self._entries = self._entries[:keep]
            self._cleaned = {i for i in self._cleaned if i < from_index}
            self._term_starts = [(i, t) for i, t in self._term_starts if i < from_index]
            if self._segment_dir is not None:
                self._persist_truncate(from_index)

    def term_at(self, index: int) -> int:
        """Term of the entry at index; falls back to term-boundary tracking for
        compacted slots. 0 means unknown (empty log, out of range, or a
        gap-filled slot whose term was never seen)."""
        entry = self.get(index)
        if entry is not None:
            return entry.term
        if index == self._prefix_index:
            return self._prefix_term  # the snapshot boundary entry's term
        if index < self._offset or index > self.last_index:
            return 0
        term = 0
        for start, t in self._term_starts:
            if start <= index:
                term = t
            else:
                break
        return term

    def __iter__(self) -> Iterator[Entry]:
        return (e for e in self._entries if e is not None)

    def __len__(self) -> int:
        return len(self._entries)

    # -- cleaning / compaction --------------------------------------------

    def clean(self, index: int) -> None:
        self._cleaned.add(index)

    def is_cleaned(self, index: int) -> bool:
        return index in self._cleaned

    @property
    def cleaned_count(self) -> int:
        return len(self._cleaned)

    def compact(self, global_index: int) -> int:
        """Null out cleaned entries with index <= global_index (the minimum
        index applied on ALL servers).  Returns the number reclaimed."""
        reclaimed = 0
        for index in [i for i in self._cleaned if i <= global_index]:
            slot = index - self._offset
            if 0 <= slot < len(self._entries) and self._entries[slot] is not None:
                self._entries[slot] = None
                reclaimed += 1
            self._cleaned.discard(index)
        return reclaimed

    # -- prefix truncation (snapshot plane, docs/DURABILITY.md) ------------

    def truncate_prefix(self, to_index: int) -> int:
        """Release entries ``<= to_index`` behind a state-machine snapshot;
        returns the number of live entries dropped.  Unlike ``compact()``
        (which nulls slots but keeps the index range), this moves the log's
        base: recovery replays only the surviving tail, and segment files
        wholly behind the boundary are deleted from disk."""
        to_index = min(to_index, self.last_index)
        if to_index < self._offset:
            return 0
        drop = to_index - self._offset + 1
        released = sum(1 for e in self._entries[:drop] if e is not None)
        # the boundary term BEFORE dropping the entries that know it
        prefix_term = self.term_at(to_index)
        first_term = self.term_at(to_index + 1) if to_index < self.last_index else 0
        del self._entries[:drop]
        self._offset = to_index + 1
        self._prefix_index = to_index
        self._prefix_term = prefix_term
        self._cleaned = {i for i in self._cleaned if i > to_index}
        self._term_starts = [(i, t) for i, t in self._term_starts if i > to_index]
        if self._entries and first_term and (
                not self._term_starts or self._term_starts[0][0] > self._offset):
            self._term_starts.insert(0, (self._offset, first_term))
        if self._segment_dir is not None:
            self._persist_prefix()
            self._drop_covered_segments(to_index)
        return released

    def reset_to(self, index: int, term: int) -> None:
        """Discard the ENTIRE log and restart it just past ``index`` (a
        snapshot install whose boundary the local log cannot match): the
        snapshot is committed state, so everything local — including any
        conflicting tail — is superseded or will be re-replicated."""
        self._entries = []
        self._offset = index + 1
        self._prefix_index = index
        self._prefix_term = term
        self._cleaned = set()
        self._term_starts = []
        if self._segment_dir is not None:
            self.close()
            for fname in os.listdir(self._segment_dir):
                if fname.startswith(f"{self._name}-") and fname.endswith((".seg", ".mseg")):
                    os.remove(os.path.join(self._segment_dir, fname))
            self._segment_count = 0
            self._persist_prefix()

    def _segment_starts(self) -> list[tuple[int, str]]:
        """(first entry index, path) of every segment file, ascending."""
        out = []
        for fname in os.listdir(self._segment_dir):
            if not fname.startswith(f"{self._name}-"):
                continue
            stem, _, ext = fname.rpartition(".")
            if ext in ("seg", "mseg"):
                out.append((int(stem[len(self._name) + 1:]),
                            os.path.join(self._segment_dir, fname)))
        return sorted(out)

    def _drop_covered_segments(self, to_index: int) -> None:
        """Delete segment files whose every entry is ``<= to_index``.  A
        segment's coverage ends where the next one starts, so the newest
        (active) segment is never deleted and partially-covered segments
        stay — recovery skips their below-prefix entries via the marker."""
        starts = self._segment_starts()
        for k, (_, path) in enumerate(starts[:-1]):
            if starts[k + 1][0] <= to_index + 1:
                os.remove(path)

    def sync(self) -> None:
        """Force appended entries to stable storage (fsync/msync) — the
        ``fsync="commit"`` policy's durability point, called by the server
        whenever its commit index advances."""
        if self._segment_file is not None:
            self._segment_file.flush()
            os.fsync(self._segment_file.fileno())
        if self._mapped is not None:
            self._mapped.flush()

    # -- disk persistence --------------------------------------------------

    @property
    def _segment_dir(self) -> str | None:
        if self._storage.level in (StorageLevel.DISK, StorageLevel.MAPPED):
            return self._storage.directory
        return None

    #: MAPPED segment capacity (frame bytes; oversize frames get their own
    #: segment).  Small segments keep the reference's roll-over semantics
    #: (``withMaxEntriesPerSegment``) observable in tests.
    MAPPED_SEGMENT_BYTES = 1 << 16

    def _segment_path(self, index: int) -> str:
        ext = "mseg" if self._storage.level is StorageLevel.MAPPED else "seg"
        return os.path.join(self._segment_dir, f"{self._name}-{index}.{ext}")

    def _persist(self, entry: Entry) -> None:
        data = self._serializer.write(entry)
        if self._storage.level is StorageLevel.MAPPED:
            roll = (self._mapped is None
                    or self._segment_count >= self._storage.max_entries_per_segment)
            if not roll and not self._mapped.append(data):
                roll = True  # full: close and start a segment that fits
            if roll:
                if self._mapped is not None:
                    self._mapped.close()  # close() msyncs: rolls are durable
                self._mapped = _MappedSegment(
                    self._segment_path(entry.index),
                    max(self.MAPPED_SEGMENT_BYTES,
                        _MappedSegment.FRAME_HEADER + len(data)))
                self._segment_count = 0
                if not self._mapped.append(data):
                    raise AssertionError("fresh mapped segment rejected frame")
            self._segment_count += 1
            if self._storage.fsync == "always":
                self._mapped.flush()
            return
        # [varint len][payload][varint crc32(payload, seed)]: the trailing
        # seeded CRC catches torn frames whose LENGTH survived — without
        # it, a zeroed/garbled payload tail can deserialize into a
        # plausible-but-wrong entry and silently corrupt the state
        # machine on replay (found by the partial_frame nemesis).
        frame = (BufferOutput().write_bytes(data)
                 .write_varint(zlib.crc32(data, _MappedSegment.CRC_SEED))
                 .to_bytes())
        if self._segment_file is None or self._segment_count >= self._storage.max_entries_per_segment:
            if self._segment_file is not None:
                if self._storage.fsync != "never":
                    # segment-roll boundary: the closed segment is durable
                    self._segment_file.flush()
                    os.fsync(self._segment_file.fileno())
                self._segment_file.close()
            self._segment_file = open(self._segment_path(entry.index), "ab")
            self._segment_count = 0
        self._segment_file.write(frame)
        self._segment_file.flush()
        if self._storage.fsync == "always":
            os.fsync(self._segment_file.fileno())
        self._segment_count += 1

    def _persist_truncate(self, from_index: int) -> None:
        # Truncation is rare (follower conflict resolution): rewrite all
        # segments from the surviving in-memory entries.
        self.close()
        for fname in os.listdir(self._segment_dir):
            if fname.startswith(f"{self._name}-") and fname.endswith((".seg", ".mseg")):
                os.remove(os.path.join(self._segment_dir, fname))
        self._segment_count = 0
        for entry in self._entries:
            if entry is not None:
                self._persist(entry)

    @property
    def _prefix_path(self) -> str:
        return os.path.join(self._segment_dir, f"{self._name}.trunc")

    def _persist_prefix(self) -> None:
        """Atomically persist the prefix-truncation marker (CRC-framed so a
        torn marker is detected, tmp+fsync+rename so it never half-writes)."""
        from . import snapshot as snapfile
        payload = json.dumps({"index": self._prefix_index,
                              "term": self._prefix_term}).encode()
        snapfile.write_atomic(self._prefix_path, snapfile.frame(payload))

    def _load_prefix(self) -> None:
        from . import snapshot as snapfile
        path = self._prefix_path
        if not os.path.exists(path):
            return
        try:
            with open(path, "rb") as f:
                payload = snapfile.unframe(f.read())
        except OSError:  # pragma: no cover - unreadable marker
            payload = None
        if payload is None:
            # A corrupt marker is tolerable: segments behind the (lost)
            # boundary were deleted, so replay just gap-fills None slots
            # below the snapshot index and apply skips them.
            logging.getLogger(__name__).warning(
                "prefix marker %s corrupt; recovering without it", path)
            return
        meta = json.loads(payload.decode())
        self._prefix_index = int(meta["index"])
        self._prefix_term = int(meta["term"])
        self._offset = self._prefix_index + 1

    def _recover(self) -> None:
        directory = self._storage.directory
        self._load_prefix()
        log = logging.getLogger(__name__)
        segments = []
        for fname in os.listdir(directory):
            if not fname.startswith(f"{self._name}-"):
                continue
            stem, dot, ext = fname.rpartition(".")
            if ext in ("seg", "mseg"):
                segments.append((int(stem[len(self._name) + 1:]), fname, ext))
        last_path = last_ext = None
        last_count = 0
        torn = False
        for _, fname, ext in sorted(segments):
            path = os.path.join(directory, fname)
            if torn:
                # everything past a torn point is suspect: a gap in the
                # entry sequence must never recover as silent None slots
                # (replication would log-match right past them) — drop the
                # orphaned segment; its entries re-replicate from the
                # leader like any truncated tail
                log.warning("log segment %s is past a torn frame; "
                            "dropping it", path)
                os.remove(path)
                continue
            if ext == "mseg":
                payloads, seg_torn = _MappedSegment.read_payloads_ex(path)
                frame_ends = None
            else:
                with open(path, "rb") as f:
                    raw = f.read()
                buf = BufferInput(raw)
                payloads = []
                frame_ends = []  # byte offset after each intact frame
                seg_torn = False
                while buf.remaining > 0:
                    try:
                        payload = buf.read_bytes()
                        crc = buf.read_varint()
                    except EOFError:
                        # torn tail (crash mid-append / dropped buffered
                        # write): everything before it is intact — the
                        # length-framed walk is sequential
                        seg_torn = True
                        break
                    if zlib.crc32(payload, _MappedSegment.CRC_SEED) != crc:
                        seg_torn = True
                        break
                    payloads.append(payload)
                    frame_ends.append(len(raw) - buf.remaining)
            # decode; an undecodable payload is a torn frame too (the
            # DISK format is length-framed without a per-frame CRC)
            entries = []
            for k, payload in enumerate(payloads):
                try:
                    entries.append(self._serializer.read(payload))
                except Exception:  # noqa: BLE001 - corrupt frame payload
                    seg_torn = True
                    payloads = payloads[:k]
                    break
            if seg_torn:
                torn = True
                log.warning(
                    "log segment %s has a torn/corrupt frame; recovering "
                    "the %d intact entries before it", path, len(entries))
                if ext == "seg":
                    # drop the torn bytes so continued appends never land
                    # after garbage (the MAPPED reopen() zeroes its stale
                    # region for the same reason)
                    keep = frame_ends[len(payloads) - 1] if payloads else 0
                    with open(path, "r+b") as f:
                        f.truncate(keep)
            last_path, last_ext, last_count = path, ext, len(payloads)
            for entry in entries:
                if entry.index <= self._prefix_index:
                    # a partially-covered segment: its low entries are
                    # behind the snapshot boundary and already released
                    continue
                # Replayed entries keep their persisted indices.  Gap-filled
                # (compacted-elsewhere) slots were never persisted, so recovery
                # re-creates the gaps as None slots.
                if entry.index > self.last_index:
                    while self.last_index + 1 < entry.index:
                        self._entries.append(None)
                    self._entries.append(entry)
                else:
                    # Overwrite (post-truncate rewrite)
                    self._entries[entry.index - self._offset] = entry
                self._note_term(entry.index, entry.term)
        # Reopen the newest segment for continued appends so repeated
        # restarts don't accumulate one near-empty segment per run.
        if last_path is not None \
                and last_count < self._storage.max_entries_per_segment:
            if last_ext == "mseg":
                self._mapped = _MappedSegment.reopen(last_path)
            else:
                self._segment_file = open(last_path, "ab")
            self._segment_count = last_count

    def close(self) -> None:
        if self._segment_file is not None:
            self._segment_file.close()
            self._segment_file = None
        if self._mapped is not None:
            self._mapped.close()
            self._mapped = None
