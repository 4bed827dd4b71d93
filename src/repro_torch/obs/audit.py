"""Crash-safe decision audit trail (a stdlib copy of ``repro.obs.audit``).

Append-only JSONL with fsync'd rotation and TraceStore-style
quarantine recovery for torn tails. One record per
decide/plan/place/evacuate carrying the correlation ID, cache
provenance, degradation rung, and chosen counter-offer — a
reject→plan→retry chain is reconstructible offline from the log
alone.

Crash-safety model (mirrors ``service/store.py``):

* Appends go to a single active ``<name>.jsonl`` file under an
  instance lock; each record is one JSON line flushed to the OS
  buffer immediately. By default (``fsync="rotate"``) fsync happens
  at rotation and close — a hard crash can tear at most the tail of
  the active file, never a rotated one. ``fsync="always"`` fsyncs
  every record for callers that want it.
* On open, :meth:`_recover` scans the active file from the front and
  stops at the first byte that is not part of a complete,
  JSON-parseable line. Everything after that point is **quarantined,
  not deleted** (``quarantine/<seq>.<pid>.<reason>.<basename>``) and
  the file is truncated back to the last good record — restart never
  loses intact records and never silently discards torn bytes.
* Rotation renames the active file to ``<name>-NNNNNN.jsonl`` via
  ``os.replace`` and fsyncs the directory, so a rotated segment is
  durable before new appends land.
"""
from __future__ import annotations

import json
import os
import threading
import time


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class AuditLog:
    """Append-only JSONL decision log with torn-tail recovery."""

    QUARANTINE_DIR = "quarantine"

    def __init__(self, directory: str, *, name: str = "audit",
                 max_bytes: int = 8 << 20, fsync: str = "rotate"):
        if fsync not in ("rotate", "always"):
            raise ValueError(f"fsync must be 'rotate' or 'always', "
                             f"got {fsync!r}")
        self.directory = directory
        self.name = name
        self.max_bytes = max_bytes
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._qseq = 0
        self.appended = 0
        self.rotations = self._count_rotated()
        self.recovery = self._recover()
        self._seq = self.recovery["records"]
        self._fh = open(self.path, "ab")

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"{self.name}.jsonl")

    def _rotated_paths(self) -> list[str]:
        prefix = f"{self.name}-"
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith(prefix) and n.endswith(".jsonl"))
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names]

    def _count_rotated(self) -> int:
        return len(self._rotated_paths())

    def _quarantine(self, data: bytes, reason: str) -> str:
        qdir = os.path.join(self.directory, self.QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        with self._lock:
            self._qseq += 1
            seq = self._qseq
        dest = os.path.join(
            qdir, f"{seq:04d}.{os.getpid()}.{reason}."
                  f"{self.name}.jsonl")
        with open(dest, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(qdir)
        return dest

    def _recover(self) -> dict:
        """Scan the active file; quarantine and truncate a torn tail.
        Returns ``{"records", "torn_bytes", "quarantined"}``."""
        report = {"records": 0, "torn_bytes": 0, "quarantined": 0}
        if not os.path.exists(self.path):
            return report
        with open(self.path, "rb") as f:
            raw = f.read()
        pos = 0
        records = 0
        while pos < len(raw):
            nl = raw.find(b"\n", pos)
            if nl < 0:
                break  # incomplete last line — torn
            line = raw[pos:nl].strip()
            if line:
                try:
                    json.loads(line)
                except ValueError:
                    break  # corrupt line — torn from here on
                records += 1
            pos = nl + 1
        report["records"] = records
        torn = raw[pos:]
        if torn:
            report["torn_bytes"] = len(torn)
            report["quarantined"] = 1
            self._quarantine(torn, "torn")
            with open(self.path, "r+b") as f:
                f.truncate(pos)
                f.flush()
                os.fsync(f.fileno())
        return report

    def append(self, record: dict) -> dict:
        """Append one record (adds ``seq`` and ``ts``); returns the
        record as written. Thread-safe; exactly one line per call."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "ts": time.time(), **record}
            line = json.dumps(rec, separators=(",", ":"),
                              default=str).encode() + b"\n"
            self._fh.write(line)
            self._fh.flush()
            if self.fsync == "always":
                os.fsync(self._fh.fileno())
            self.appended += 1
            if self._fh.tell() >= self.max_bytes:
                self._rotate_locked()
        return rec

    def _rotate_locked(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        dest = os.path.join(
            self.directory,
            f"{self.name}-{self.rotations:06d}.jsonl")
        os.replace(self.path, dest)
        _fsync_dir(self.directory)
        self.rotations += 1
        self._fh = open(self.path, "ab")

    def records(self, kind: str | None = None) -> list[dict]:
        """All intact records, rotated segments first, in append
        order; optionally filtered by ``kind``."""
        with self._lock:
            self._fh.flush()
            paths = self._rotated_paths() + [self.path]
        out = []
        for path in paths:
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except OSError:
                continue
            for line in raw.split(b"\n"):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail of a live file
                if kind is None or rec.get("kind") == kind:
                    out.append(rec)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"appended": self.appended,
                    "rotations": self.rotations,
                    "records": self._seq,
                    "recovery": dict(self.recovery),
                    "path": self.path}

    def close(self) -> None:
        with self._lock:
            if self._fh.closed:
                return
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
