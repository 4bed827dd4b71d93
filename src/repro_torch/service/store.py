"""Disk-backed, content-addressed trace store (port of
``repro.service.store``).

Layered *under* ``core/cache.py``: a
:class:`~repro_torch.core.cache.TraceCache` constructed with
``store=TraceStore(dir)`` looks content-addressed keys up on disk after
a memory miss and writes fresh traces through, so warm estimates
survive process restarts and are shared across workers (the admission
daemon's workers, separate gate processes).

On-disk format: one JSON file per entry, named by the stable sha256 of
the full trace key (function content digest + avals + treespecs + kinds
+ phase + tag — see ``cache.stable_key_digest``). The payload is the
schema-v5 **columnar** trace format (``ColumnarTrace`` /
``ColumnarBlocks`` ``to_json``, shape tables included), plus the
input/output block summaries, the abstract outputs (``meta`` tensors,
written as shape and dtype name, read back as the same ``torch.dtype``)
and the argument leaf counts: every field of the port's
:class:`~repro_torch.core.cache.TracedPhase`. The reference resolves an
update phase's gradient-coupling verdict from its jaxpr before writing;
the port's phases carry no jaxpr and its estimator resolves the verdict
without one (eager steps release every gradient after the update that
reads it), so there is nothing to resolve.

Invalidation: every file records ``store_version`` and the trace schema
version; a mismatch on load reports a miss. LRU: the store keeps at
most ``max_entries`` files, evicting by mtime (loads touch the file's
mtime, so recently served entries survive).

Crash safety: writes go to a **unique** temp file that is fsynced and
atomically renamed over the entry (two concurrent saves of the same
digest cannot clobber each other's in-flight temp — last rename wins,
both files were complete). Anything unreadable — truncated JSON,
zero-byte files, wrong schema version, foreign payloads — is moved to
``<dir>/quarantine/`` rather than deleted, so corruption evidence
survives for inspection while the store keeps serving (the entry just
misses and is re-traced). ``__init__`` runs a startup recovery scan:
orphaned ``*.tmp`` files from mid-write crashes and zero-byte entries
are quarantined immediately and reported via ``recovery`` /
``stats()``. An optional :class:`~repro_torch.service.faults.FaultPlan`
(``faults=``) fires at ``store.load`` / ``store.save`` for chaos
testing.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import torch

from ..core.cache import BlockInfo, TracedPhase, stable_key_digest
from ..core.events import (BlockKind, ColumnarBlocks, ColumnarTrace, Trace,
                           TRACE_SCHEMA_VERSION)
from ..obs import spans as obs_spans

#: Bump to invalidate every persisted entry (payload layout changes).
STORE_VERSION = 1

_PREFIX = "xm_"


class StoreUnserializable(Exception):
    """Entry contains values the store cannot round-trip losslessly."""


# -- abstract output pytree <-> JSON -----------------------------------------
def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (read back with getattr)."""
    return str(dtype).removeprefix("torch.")


def _dtype_from_name(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dtype


def _tree_to_json(tree):
    """Serialize an abstract output pytree built from dicts / tuples /
    lists / None with tensor leaves (their shape and dtype). Anything
    else raises ``StoreUnserializable`` (the entry is then simply not
    persisted)."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        items = []
        for k, v in tree.items():
            if isinstance(k, str):
                kj = ["s", k]
            elif isinstance(k, int):
                kj = ["i", k]
            else:
                raise StoreUnserializable(f"dict key {k!r}")
            items.append([kj, _tree_to_json(v)])
        return {"t": "dict", "items": items}
    if type(tree) is tuple:         # a namedtuple would come back plain
        return {"t": "tuple", "items": [_tree_to_json(v) for v in tree]}
    if isinstance(tree, list):
        return {"t": "list", "items": [_tree_to_json(v) for v in tree]}
    if isinstance(tree, torch.Tensor):
        return {"t": "leaf", "shape": [int(d) for d in tree.shape],
                "dtype": _dtype_name(tree.dtype)}
    raise StoreUnserializable(f"pytree node {type(tree)!r}")


def _tree_from_json(d):
    t = d["t"]
    if t == "none":
        return None
    if t == "dict":
        out = {}
        for (kt, k), vj in d["items"]:
            out[k if kt == "s" else int(k)] = _tree_from_json(vj)
        return out
    if t == "tuple":
        return tuple(_tree_from_json(v) for v in d["items"])
    if t == "list":
        return [_tree_from_json(v) for v in d["items"]]
    if t == "leaf":
        return torch.empty(tuple(d["shape"]),
                           dtype=_dtype_from_name(d["dtype"]),
                           device="meta")
    raise ValueError(f"unknown pytree node {t!r}")


def _blocks_to_json(blocks) -> list:
    return [[b.bid, b.size, b.kind.value,
             None if b.shape is None else list(b.shape)] for b in blocks]


def _blocks_from_json(rows) -> tuple:
    return tuple(BlockInfo(int(bid), int(size), BlockKind(kind),
                           None if shape is None else tuple(shape))
                 for bid, size, kind, shape in rows)


def phase_to_json(entry: TracedPhase) -> dict:
    """Payload dict for one ``TracedPhase``: every field."""
    meta = {k: v for k, v in entry.trace.meta.items() if k != "_columns"}
    try:
        json.dumps(meta)
    except (TypeError, ValueError):
        meta = {}
    return {
        "trace": {
            "columns": entry.trace.columnar().to_json(),
            "num_iterations": entry.trace.num_iterations,
            "meta": meta,
        },
        "lifecycles": ColumnarBlocks.from_lifecycles(
            entry.lifecycles).to_json(),
        "input_blocks": _blocks_to_json(entry.input_blocks),
        "output_blocks": _blocks_to_json(entry.output_blocks),
        "out_shape": _tree_to_json(entry.out_shape),
        "arg_leaf_counts": list(entry.arg_leaf_counts),
    }


def phase_from_json(d: dict) -> TracedPhase:
    trace = Trace.from_columnar(
        ColumnarTrace.from_json(d["trace"]["columns"]),
        num_iterations=d["trace"]["num_iterations"],
        meta=d["trace"].get("meta", {}))
    return TracedPhase(
        trace=trace,
        lifecycles=tuple(
            ColumnarBlocks.from_json(d["lifecycles"]).to_lifecycles()),
        input_blocks=_blocks_from_json(d["input_blocks"]),
        output_blocks=_blocks_from_json(d["output_blocks"]),
        out_shape=_tree_from_json(d["out_shape"]),
        arg_leaf_counts=tuple(d["arg_leaf_counts"]),
    )


class TraceStore:
    """Content-addressed persistent trace store (see module docstring).

    Duck-typed for ``TraceCache(store=...)``: ``load(key)``,
    ``save(key, entry)``, ``stats()``.
    """

    QUARANTINE_DIR = "quarantine"

    def __init__(self, directory: str, max_entries: int = 256,
                 faults=None):
        self.directory = directory
        self.max_entries = max_entries
        self.faults = faults        # optional FaultPlan (chaos testing)
        self._lock = threading.RLock()
        self.loads = 0
        self.saves = 0
        # seconds spent in successful loads (read, parse, decode) and
        # saves (encode, write, fsync, rename)
        self.load_s = 0.0
        self.save_s = 0.0
        self.load_misses = 0
        self.invalidated = 0
        self.quarantined = 0
        self._qseq = 0
        os.makedirs(directory, exist_ok=True)
        self.recovery = self._recover()

    # -- paths ---------------------------------------------------------------
    def path_for(self, key: tuple) -> str:
        return os.path.join(self.directory,
                            _PREFIX + stable_key_digest(key) + ".json")

    @property
    def quarantine_path(self) -> str:
        return os.path.join(self.directory, self.QUARANTINE_DIR)

    def _entries(self) -> list[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names
                if n.startswith(_PREFIX) and n.endswith(".json")]

    def __len__(self) -> int:
        return len(self._entries())

    # -- quarantine & recovery ----------------------------------------------
    def _quarantine(self, path: str, reason: str) -> str | None:
        """Move a bad file into the quarantine directory (never delete
        evidence). Returns the destination, or None if the file was
        already gone (e.g. a racing quarantine won)."""
        with self._lock:
            self._qseq += 1
            seq = self._qseq
        dest = os.path.join(
            self.quarantine_path,
            f"{seq:04d}.{os.getpid()}.{reason}.{os.path.basename(path)}")
        try:
            os.makedirs(self.quarantine_path, exist_ok=True)
            os.replace(path, dest)
        except OSError:
            return None
        with self._lock:
            self.quarantined += 1
        obs_spans.event("store.quarantine", reason=reason)
        return dest

    def _recover(self) -> dict:
        """Startup scan: quarantine mid-write leftovers (``*.tmp``) and
        zero-byte entries so a crashed writer cannot poison later loads.
        Deeper corruption (truncated JSON, wrong version) is detected —
        and quarantined — lazily by ``load``; scanning is O(names), not
        O(bytes)."""
        report = {"scanned": 0, "quarantined_tmp": 0,
                  "quarantined_empty": 0}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return report
        for name in names:
            path = os.path.join(self.directory, name)
            if name.endswith(".tmp"):
                report["scanned"] += 1
                if self._quarantine(path, "orphan-tmp"):
                    report["quarantined_tmp"] += 1
                continue
            if name.startswith(_PREFIX) and name.endswith(".json"):
                report["scanned"] += 1
                try:
                    empty = os.path.getsize(path) == 0
                except OSError:
                    continue
                if empty and self._quarantine(path, "zero-byte"):
                    report["quarantined_empty"] += 1
        return report

    # -- load / save ---------------------------------------------------------
    def load(self, key: tuple) -> TracedPhase | None:
        # the file read + JSON parse + columnar decode run WITHOUT the
        # lock (concurrent workers warming from disk must not serialize
        # behind each other); only counters and quarantine moves lock
        path = self.path_for(key)
        if self.faults is not None:
            self.faults.check("store.load", path=path)
        t0 = time.perf_counter()
        try:
            with obs_spans.span("store.load"), open(path) as f:
                d = json.load(f)
        except OSError:             # absent: a plain miss, no evidence
            with self._lock:
                self.load_misses += 1
            return None
        except ValueError:          # unparseable: quarantine the bytes
            self._quarantine(path, "bad-json")
            with self._lock:
                self.invalidated += 1
                self.load_misses += 1
            return None
        # the port has written only schema-v5 entries: anything else
        # quarantines
        if (d.get("store_version") != STORE_VERSION
                or d.get("trace_schema") != TRACE_SCHEMA_VERSION):
            self._quarantine(path, "version")
            with self._lock:
                self.invalidated += 1
                self.load_misses += 1
            return None
        try:
            entry = phase_from_json(d["phase"])
        except Exception:   # noqa: BLE001 — corrupt/foreign payload
            self._quarantine(path, "bad-payload")
            with self._lock:
                self.invalidated += 1
                self.load_misses += 1
            return None
        try:
            os.utime(path)          # LRU touch
        except OSError:
            pass
        with self._lock:
            self.loads += 1
            self.load_s += time.perf_counter() - t0
        return entry

    def save(self, key: tuple, entry: TracedPhase) -> None:
        t0 = time.perf_counter()
        try:
            payload = phase_to_json(entry)
        except StoreUnserializable:
            return
        d = {
            "store_version": STORE_VERSION,
            "trace_schema": TRACE_SCHEMA_VERSION,
            "saved_at": time.time(),
            "tag": key[1],
            "phase": payload,
        }
        path = self.path_for(key)
        # crash-safe write OUTSIDE the lock: a unique temp name per
        # writer (mkstemp), fsync before the atomic rename, then a
        # directory fsync so the rename itself survives a crash.
        # Concurrent saves of one digest each complete their own temp
        # file; whichever renames last wins — no writer ever touches
        # another writer's temp file.
        tmp = None
        try:
            with obs_spans.span("store.save"):
                fd, tmp = tempfile.mkstemp(
                    dir=self.directory,
                    prefix=_PREFIX + "w", suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump(d, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                tmp = None
                self._fsync_dir()
        except OSError:
            if tmp is not None:
                self._remove(tmp)   # our own temp only
            return
        if self.faults is not None:
            # simulated mid-write crash: mangle the *persisted* entry so
            # the damage surfaces at the next load (quarantine path)
            self.faults.check("store.save", path=path)
        with self._lock:
            self.saves += 1
            self.save_s += time.perf_counter() - t0
            self._evict_lru()

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.directory, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(dfd)
        except OSError:
            pass
        finally:
            os.close(dfd)

    def _remove(self, path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def _evict_lru(self) -> None:
        entries = self._entries()
        if len(entries) <= self.max_entries:
            return
        def mtime(p):
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0
        entries.sort(key=mtime)
        for p in entries[:len(entries) - self.max_entries]:
            self._remove(p)

    def clear(self) -> None:
        with self._lock:
            for p in self._entries():
                self._remove(p)

    def stats(self) -> dict:
        return {"dir": self.directory, "entries": len(self),
                "max_entries": self.max_entries, "loads": self.loads,
                "load_misses": self.load_misses, "saves": self.saves,
                "load_s": self.load_s, "save_s": self.save_s,
                "invalidated": self.invalidated,
                "quarantined": self.quarantined,
                "recovery": dict(self.recovery),
                "store_version": STORE_VERSION}
