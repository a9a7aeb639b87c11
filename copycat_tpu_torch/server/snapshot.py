"""Atomic, CRC-framed state-machine snapshot files (the crash-recovery plane).

The reference has no snapshots — durability is "retained commits + replay"
(SURVEY.md §5.4), so a long-lived member replays its whole log to boot and
compaction can never release a segment a peer might still need.  This store
is the durable half of the fix (docs/DURABILITY.md): the server serializes
its state machines + session plane at ``last_applied`` into one payload,
and this module owns the file discipline —

- **atomic**: payload is written to a ``.tmp`` sibling, fsynced, then
  ``os.replace``d into place (a crash never leaves a half-written ``.snap``
  visible under the final name);
- **CRC-framed**: ``[magic][u64 len][u32 crc32(payload, seed)][payload]``,
  same seeded-CRC discipline as the mapped log segments (``log.py``) so an
  all-zero torn file can never validate;
- **self-healing reads**: ``newest()`` walks snapshots newest-first and
  skips any file that fails the frame check — a corrupt newest snapshot
  falls back to the previous one (or to full replay when none survive),
  never to a crash at boot.

File name carries the applied index (``{name}-{index:016d}.snap``) so
ordering is lexicographic and the install plane can serve "the newest
snapshot" without opening every file.
"""

from __future__ import annotations

import logging
import os
import zlib

logger = logging.getLogger(__name__)

#: Frame magic + format version; bump the digit when the payload schema
#: changes incompatibly so old files fail loudly instead of misparsing.
MAGIC = b"CCSNAP1\n"
#: Nonzero CRC seed (same rationale as ``_MappedSegment.CRC_SEED``):
#: crc32(b"") == 0, so with a zero seed an all-zero torn file would
#: validate as an empty payload.
CRC_SEED = 0x5A9C
_HEADER = len(MAGIC) + 8 + 4


def frame(payload: bytes) -> bytes:
    """CRC-frame one snapshot payload."""
    return (MAGIC + len(payload).to_bytes(8, "little")
            + zlib.crc32(payload, CRC_SEED).to_bytes(4, "little") + payload)


def unframe(data: bytes) -> bytes | None:
    """Payload of a framed snapshot, or ``None`` when the frame is torn,
    truncated, or corrupt (bad magic / short payload / CRC mismatch)."""
    if len(data) < _HEADER or not data.startswith(MAGIC):
        return None
    length = int.from_bytes(data[len(MAGIC):len(MAGIC) + 8], "little")
    crc = int.from_bytes(data[len(MAGIC) + 8:_HEADER], "little")
    payload = data[_HEADER:_HEADER + length]
    if len(payload) < length or zlib.crc32(payload, CRC_SEED) != crc:
        return None
    return payload


def fsync_dir(directory: str) -> None:
    """Best-effort directory fsync so a rename survives power loss (not
    all platforms/filesystems allow opening a directory for sync)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-dependent
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)


def write_atomic(path: str, data: bytes) -> None:
    """tmp + fsync + atomic rename: the file at ``path`` is either the old
    content or the complete new content, never a torn mix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


class SnapshotStore:
    """Snapshot files of one server under its storage directory."""

    def __init__(self, directory: str, name: str) -> None:
        self.directory = directory
        self.name = name
        os.makedirs(directory, exist_ok=True)
        #: Snapshots skipped by ``newest()`` for failing the frame check
        #: since this store opened (surfaced as ``snap.bad_crc_skipped``).
        self.bad_skipped = 0

    def _path(self, index: int) -> str:
        return os.path.join(self.directory, f"{self.name}-{index:016d}.snap")

    def indexes(self) -> list[int]:
        """Applied indexes of all snapshot files, ascending."""
        out = []
        prefix = f"{self.name}-"
        for fname in os.listdir(self.directory):
            if fname.startswith(prefix) and fname.endswith(".snap"):
                try:
                    out.append(int(fname[len(prefix):-len(".snap")]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, index: int, payload: bytes) -> str:
        """Persist one snapshot payload atomically; returns its path."""
        path = self._path(index)
        write_atomic(path, frame(payload))
        return path

    def newest(self) -> tuple[int, bytes] | None:
        """``(index, payload)`` of the newest snapshot that passes the
        frame check; corrupt files are skipped (logged + counted), falling
        back to older snapshots and finally to ``None`` (full replay)."""
        for index in reversed(self.indexes()):
            path = self._path(index)
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            payload = unframe(data)
            if payload is None:
                self.bad_skipped += 1
                logger.warning(
                    "snapshot %s failed its CRC frame check; skipping "
                    "(falling back to an older snapshot or full replay)",
                    path)
                continue
            return index, payload
        return None

    def gc(self, keep: int = 2) -> int:
        """Delete all but the ``keep`` newest snapshot files; returns the
        number removed. Keeping one spare means a corrupt newest snapshot
        still recovers from the previous one instead of a full replay."""
        removed = 0
        for index in self.indexes()[:-keep if keep else None]:
            try:
                os.remove(self._path(index))
                removed += 1
            except OSError:  # pragma: no cover - racing cleanup
                pass
        return removed
