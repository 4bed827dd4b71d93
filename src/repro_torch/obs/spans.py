"""Structured tracing spans.

A :class:`Tracer` collects context-manager spans with monotonic
timings, parent links, and a per-request **correlation ID** minted in
``AdmissionService.decide`` and carried — via a ``contextvars``
context — through ``TraceCache`` lookups, the columnar replay, the
degradation-ladder rungs, ``RemediationPlanner`` searches and
``FleetScheduler`` placements/evictions. Finished spans export as
Chrome-trace / Perfetto JSON (:meth:`Span.to_chrome_trace` /
:meth:`Tracer.to_chrome_trace`).

Deep pipeline layers never hold an observability handle: they call the
module-level :func:`span` / :func:`event` helpers, which read the
active context from a :class:`contextvars.ContextVar`. When no context
is active (observability disabled — the default) the helpers cost one
``ContextVar.get`` returning ``None`` and a shared ``nullcontext``:
the instrumented pipeline stays bit-identical and within the <3%
overhead gate. ``decide`` runs *on* the worker thread for
``decide_many``, so the ContextVar propagates to every layer a
decision touches without explicit plumbing; the deadline side-thread
(``_call_with_deadline``) copies the caller's context explicitly.

Zero dependencies beyond the standard library by design — this module
must be importable from ``core/`` without cycles.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import threading
import time
from collections import deque


@dataclasses.dataclass(slots=True)
class Span:
    """One finished (or in-flight) operation. Timings are
    ``time.perf_counter`` seconds — monotonic, arbitrary origin.
    Slotted: spans are allocated several times per decision on the
    warm path, and skipping the per-instance ``__dict__`` is part of
    staying inside the <3% instrumentation-overhead gate."""

    name: str
    span_id: int
    parent_id: int | None
    correlation_id: str | None
    t_start: float
    t_end: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    thread: int = 0

    @property
    def duration_s(self) -> float:
        return (self.t_end if self.t_end is not None
                else self.t_start) - self.t_start

    def to_chrome_trace(self) -> dict:
        """One Chrome-trace *complete* ("X") event — ts/dur in µs, as
        chrome://tracing and Perfetto expect."""
        args = {k: v for k, v in self.attrs.items()}
        if self.correlation_id:
            args["correlation_id"] = self.correlation_id
        if self.parent_id is not None:
            args["parent_span"] = self.parent_id
        return {"name": self.name, "ph": "X", "pid": os.getpid(),
                "tid": self.thread, "ts": round(self.t_start * 1e6, 3),
                "dur": round(self.duration_s * 1e6, 3), "args": args}


class Tracer:
    """Thread-safe collector of finished spans (bounded ring buffer —
    the oldest spans fall off under sustained load; ``dropped`` counts
    them so truncation is never silent)."""

    def __init__(self, max_spans: int = 4096):
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: deque[tuple] = deque(maxlen=max_spans)
        # itertools.count.__next__ is a single C call — atomic under
        # the GIL, so span-id allocation needs no lock
        self._ids = itertools.count(1)
        # the span stack is a ContextVar, not thread-local state: a
        # context copied onto a side thread keeps its parent links
        self._stack: contextvars.ContextVar[tuple] = \
            contextvars.ContextVar("xmem_span_stack", default=())
        self.started = 0
        self.dropped = 0

    def _open(self, name: str, correlation_id: str | None,
              attrs: dict) -> Span:
        sid = next(self._ids)
        parents = self._stack.get()
        parent = parents[-1] if parents else None
        return Span(
            name=name, span_id=sid,
            parent_id=parent.span_id if parent is not None else None,
            correlation_id=correlation_id or (
                parent.correlation_id if parent is not None else None),
            t_start=time.perf_counter(), attrs=attrs,
            thread=threading.get_ident())

    def _close(self, sp: Span) -> None:
        sp.t_end = time.perf_counter()
        # retain a plain tuple, not the Span object: tuples/dicts of
        # scalars are untracked by the cyclic GC after their first
        # survey, so a full 4096-entry ring adds nothing to collection
        # scans — while retained *objects* churn into gen2 and trigger
        # full collections over the (large) JAX heap, which is the
        # dominant instrumentation cost on the warm decide path
        rec = (sp.name, sp.span_id, sp.parent_id, sp.correlation_id,
               sp.t_start, sp.t_end, sp.attrs, sp.thread)
        with self._lock:
            self.started += 1
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(rec)

    def span(self, name: str, correlation_id: str | None = None,
             **attrs) -> "_SpanHandle":
        """Context manager: a span covering the ``with`` body. Nested
        spans link to their parent automatically. (A slotted handle,
        not a ``contextlib`` generator — this sits on the warm decide
        path, where generator setup/teardown is measurable against
        the <3% overhead gate.)"""
        return _SpanHandle(self, self._open(name, correlation_id,
                                            attrs))

    def event(self, name: str, correlation_id: str | None = None,
              **attrs) -> Span:
        """A zero-duration span (point annotation, e.g. a cache hit)."""
        sp = self._open(name, correlation_id, attrs)
        self._close(sp)
        return sp

    def spans(self) -> list[Span]:
        with self._lock:
            recs = list(self._spans)
        return [Span(name=r[0], span_id=r[1], parent_id=r[2],
                     correlation_id=r[3], t_start=r[4], t_end=r[5],
                     attrs=r[6], thread=r[7]) for r in recs]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.started = 0
            self.dropped = 0

    def to_chrome_trace(self) -> dict:
        """The collected spans as a Chrome-trace JSON object — load it
        in chrome://tracing or ui.perfetto.dev."""
        return {"traceEvents": [s.to_chrome_trace()
                                for s in self.spans()],
                "displayTimeUnit": "ms"}

    def stats(self) -> dict:
        with self._lock:
            return {"spans": len(self._spans), "started": self.started,
                    "dropped": self.dropped,
                    "max_spans": self.max_spans}


class _SpanHandle:
    """Minimal enter/exit wrapper pairing :meth:`Tracer._open` with
    :meth:`Tracer._close`; yields the :class:`Span`."""

    __slots__ = ("_tracer", "_span", "_token")

    def __init__(self, tracer: Tracer, span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        stack = self._tracer._stack
        self._token = stack.set(stack.get() + (self._span,))
        return self._span

    def __exit__(self, *exc) -> bool:
        self._tracer._stack.reset(self._token)
        self._tracer._close(self._span)
        return False


# -- the active observability context ----------------------------------------
@dataclasses.dataclass
class ObsContext:
    """What deep layers see while a request is being decided."""

    tracer: Tracer
    correlation_id: str | None = None


_ACTIVE: contextvars.ContextVar[ObsContext | None] = \
    contextvars.ContextVar("xmem_obs_ctx", default=None)

#: Shared no-op context manager — nullcontext is reentrant and
#: reusable, so one instance serves every disabled call site.
_NOOP = contextlib.nullcontext()


def current() -> ObsContext | None:
    """The active observability context, or None (disabled)."""
    return _ACTIVE.get()


def current_correlation_id() -> str | None:
    ctx = _ACTIVE.get()
    return ctx.correlation_id if ctx is not None else None


def span(name: str, **attrs):
    """A span on the active tracer, or a shared no-op context manager
    when observability is off — one ``ContextVar.get`` either way."""
    ctx = _ACTIVE.get()
    if ctx is None:
        return _NOOP
    return ctx.tracer.span(name, correlation_id=ctx.correlation_id,
                           **attrs)


def event(name: str, **attrs) -> None:
    """A zero-duration annotation on the active tracer (no-op when
    observability is off)."""
    ctx = _ACTIVE.get()
    if ctx is not None:
        ctx.tracer.event(name, correlation_id=ctx.correlation_id,
                         **attrs)


class activate:
    """Install an observability context for the ``with`` body — the
    service's per-request entry point. (Class-based rather than a
    ``contextlib`` generator: it runs once per decision.)"""

    __slots__ = ("_ctx", "_token")

    def __init__(self, tracer: Tracer,
                 correlation_id: str | None = None):
        self._ctx = ObsContext(tracer, correlation_id)

    def __enter__(self) -> ObsContext:
        self._token = _ACTIVE.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> bool:
        _ACTIVE.reset(self._token)
        return False


def mint_correlation_id(prefix: str = "xm") -> str:
    """A fresh per-request correlation ID (64 random bits — the same
    entropy as ``uuid4().hex[:16]`` but without the UUID object
    construction, which is measurable at per-decide frequency)."""
    return f"{prefix}-{os.urandom(8).hex()}"
