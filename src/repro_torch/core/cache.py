"""Trace cache: stage-1 memoization for repeated estimates.

A gate that tries several batch sizes, or re-estimates the same job,
would trace the optimizer's init and update phases again for every
candidate although they do not depend on the batch. This module caches
the whole product of one phase trace (the event stream, the lifecycles,
the input/output block summaries and the abstract outputs) keyed on

    (function identity, input shapes + dtypes + treespecs, arg kinds,
     phase, call-site tag)

Function identity is content-addressed where possible: a digest over
the function's code object (bytecode, consts, nested code), defaults,
closure cells and the module-level values it reads. Re-created but
structurally identical closures (``make_estimator_hooks`` builds new
ones for every decision) therefore hit. Functions whose closures cannot
be hashed canonically fall back to a weak ``id(fn)`` reference.

A port of ``repro.core.cache`` without its persistent store (the
admission service is not ported). Each ``XMemEstimator`` owns one cache
unless the caller passes a shared one. Entries are immutable by
contract: consumers copy before rewriting lifecycles.
"""
from __future__ import annotations

import dataclasses
import enum as _enum
import functools
import hashlib
import threading
import types
import weakref
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np
import torch

from ..obs import spans as obs_spans
from .events import BlockKind, BlockLifecycle, Trace


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    """Summary of a tracer input/output block (shape None = unknown)."""

    bid: int
    size: int
    kind: BlockKind
    shape: tuple | None = None


@dataclasses.dataclass(frozen=True)
class TracedPhase:
    """Everything the later stages need from one phase trace.

    ``out_shape`` is the step's output pytree as ``meta`` tensors (the
    update phase's grads and the optimizer state are traced from it);
    ``arg_leaf_counts`` is the number of tensor leaves of each argument.
    """

    trace: Trace
    lifecycles: tuple[BlockLifecycle, ...]
    input_blocks: tuple[BlockInfo, ...] = ()
    output_blocks: tuple[BlockInfo, ...] = ()
    out_shape: Any = None
    arg_leaf_counts: tuple[int, ...] = ()

    @property
    def num_events(self) -> int:
        return len(self.trace.events)


def _aval_sig(leaf) -> tuple:
    return (tuple(getattr(leaf, "shape", ())), str(getattr(leaf, "dtype",
                                                          None)))


# -- content-addressed function identity -------------------------------------
class _Uncanonical(Exception):
    """A value that cannot be hashed structurally (no content key)."""


_CANON_DEPTH_CAP = 12


def _canon_code(code, seen: frozenset, depth: int) -> tuple:
    consts = []
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            consts.append(_canon_code(c, seen, depth + 1))
        else:
            consts.append(_canon(c, seen, depth + 1))
    return ("code", code.co_name, code.co_code, tuple(consts),
            code.co_names, code.co_freevars)


def _code_names(code) -> set:
    names = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _code_names(c)
    return names


def _canon_global(name: str, v, seen: frozenset, depth: int) -> tuple:
    """Lenient canonical form of a module-level value a function reads:
    an unhashable value degrades to its type name (the digest then
    tracks code and closures but not mutations of that one global)."""
    if isinstance(v, types.ModuleType):
        return (name, "mod", v.__name__)
    try:
        return (name, _canon(v, seen, depth))
    except _Uncanonical:
        return (name, "other", type(v).__qualname__)


def _canon_fn(fn, seen: frozenset, depth: int) -> tuple:
    if id(fn) in seen:          # recursive function: name-level reference
        return ("fnref", getattr(fn, "__qualname__", "?"))
    seen = seen | {id(fn)}
    code = fn.__code__
    cells = []
    for cell in fn.__closure__ or ():
        try:
            cells.append(_canon(cell.cell_contents, seen, depth + 1))
        except ValueError:      # empty cell
            cells.append(("emptycell",))
    gl = fn.__globals__
    globals_sig = tuple(
        _canon_global(n, gl[n], seen, depth + 1)
        for n in sorted(_code_names(code)) if n in gl)
    return ("fn", fn.__module__, fn.__qualname__,
            _canon_code(code, seen, depth + 1),
            _canon(fn.__defaults__ or (), seen, depth + 1),
            _canon(fn.__kwdefaults__ or {}, seen, depth + 1),
            tuple(cells), globals_sig)


def _canon(v, seen: frozenset, depth: int):
    """Canonical (deterministically reprable) structure for ``v``, or
    raise :class:`_Uncanonical`."""
    if depth > _CANON_DEPTH_CAP:
        raise _Uncanonical(f"depth cap at {type(v)!r}")
    if v is None or v is Ellipsis or isinstance(
            v, (bool, int, float, str, bytes)):
        return ("v", repr(v))
    if isinstance(v, _enum.Enum):
        return ("enum", type(v).__qualname__, repr(v.value))
    if isinstance(v, (torch.dtype, np.dtype)):
        return ("dtype", str(v))
    if isinstance(v, (tuple, list)):
        return ("seq", type(v).__name__,
                tuple(_canon(x, seen, depth + 1) for x in v))
    if isinstance(v, (dict, types.MappingProxyType)):
        items = sorted(
            ((_canon(k, seen, depth + 1), _canon(x, seen, depth + 1))
             for k, x in v.items()), key=repr)
        return ("dict", tuple(items))
    if isinstance(v, types.FunctionType):
        return _canon_fn(v, seen, depth)
    if isinstance(v, types.MethodType):
        return ("method", _canon_fn(v.__func__, seen, depth),
                _canon(v.__self__, seen, depth + 1))
    if isinstance(v, types.BuiltinFunctionType):
        return ("builtin", getattr(v, "__module__", None) or "",
                v.__qualname__)
    if isinstance(v, functools.partial):
        return ("partial", _canon(v.func, seen, depth + 1),
                _canon(tuple(v.args), seen, depth + 1),
                _canon(dict(v.keywords or {}), seen, depth + 1))
    if isinstance(v, type):
        return ("type", getattr(v, "__module__", ""), v.__qualname__)
    if dataclasses.is_dataclass(v):
        return ("dc", type(v).__qualname__, tuple(
            (f.name, _canon(getattr(v, f.name), seen, depth + 1))
            for f in dataclasses.fields(v)))
    if isinstance(v, torch.Tensor):
        if v.device.type == "cpu" and v.numel() <= 256:
            return ("arr", tuple(v.shape), str(v.dtype),
                    v.detach().contiguous().numpy().tobytes())
        return ("aval", tuple(v.shape), str(v.dtype))
    raise _Uncanonical(f"unhashable {type(v)!r}")


#: memoized digests for function objects still alive
_FN_DIGEST_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_NO_DIGEST = object()


def fn_digest(fn) -> str | None:
    """Content digest of a function (sha256 hex), or None when its
    code/closure/defaults cannot be canonically hashed."""
    try:
        memo = _FN_DIGEST_MEMO.get(fn)
    except TypeError:
        memo = None
    if memo is not None:
        return None if memo is _NO_DIGEST else memo
    try:
        canon = _canon(fn, frozenset(), 0)
        digest = hashlib.sha256(repr(canon).encode()).hexdigest()
    except _Uncanonical:
        digest = None
    try:
        _FN_DIGEST_MEMO[fn] = _NO_DIGEST if digest is None else digest
    except TypeError:
        pass
    return digest


def fn_identity(fn) -> tuple | None:
    """``("code", digest)`` when content-addressable, ``("id", id(fn))``
    when only weak identity is safe, None when ``fn`` cannot be
    weak-referenced either (caching skipped)."""
    digest = fn_digest(fn)
    if digest is not None:
        return ("code", digest)
    try:
        weakref.ref(fn)
    except TypeError:
        return None
    return ("id", id(fn))


def trace_key(fn, tag: str, flat_leaves: Sequence, treedefs: tuple,
              kinds: Sequence[BlockKind], phase) -> tuple | None:
    """A cache key, or None when ``fn`` has no safe identity."""
    ident = fn_identity(fn)
    if ident is None:
        return None
    return (ident, tag,
            tuple(_aval_sig(leaf) for leaf in flat_leaves),
            # TreeSpecs by their deterministic str form: a plain string
            # still hashes while the interpreter shuts down, when a dead
            # function's weakref callback evicts its entry
            tuple(str(t) for t in treedefs),
            tuple(k.value for k in kinds),
            getattr(phase, "value", phase))


def key_is_content_addressed(key: tuple | None) -> bool:
    return key is not None and key[0][0] == "code"


class TraceCache:
    """Thread-safe LRU of ``TracedPhase`` entries with hit/miss counts."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._data: "OrderedDict[tuple, tuple[weakref.ref | None, TracedPhase]]" \
            = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get(self, fn, key: tuple | None) -> TracedPhase | None:
        with self._lock:
            ent = self._data.get(key) if key is not None else None
            if ent is not None:
                ref, payload = ent
                if ref is None or ref() is fn:
                    self.hits += 1
                    self._data.move_to_end(key)
                    return payload
                del self._data[key]   # id() was recycled: stale entry
            self.misses += 1
        obs_spans.event("trace_cache.misses")
        return None

    def _insert(self, key: tuple, ref, payload: TracedPhase) -> None:
        self._data[key] = (ref, payload)
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)

    def put(self, fn, key: tuple | None, payload: TracedPhase) -> None:
        if key is None:
            return
        if key_is_content_addressed(key):
            # any function with the same digest gives the same trace
            with self._lock:
                self._insert(key, None, payload)
            return
        data = self._data

        def _evict(_ref, _key=key):
            # the function died: its entry can never hit again
            with self._lock:
                ent = data.get(_key)
                if ent is not None and ent[0] is _ref:
                    del data[_key]

        try:
            ref = weakref.ref(fn, _evict)
        except TypeError:
            return
        with self._lock:
            self._insert(key, ref, payload)

    def __len__(self) -> int:
        return len(self._data)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._data), "maxsize": self.maxsize}
