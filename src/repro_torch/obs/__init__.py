"""Observability for the PyTorch port.

Stdlib copies of the JAX package's ``repro.obs`` modules:

* :mod:`repro_torch.obs.spans` — context-manager tracing spans with a
  per-request correlation ID, exportable as Chrome-trace JSON; the
  estimator and simulator open spans through it;
* :mod:`repro_torch.obs.metrics` — thread-safe counters / gauges /
  bounded-reservoir histograms, exported as Prometheus text and JSON;
* :mod:`repro_torch.obs.audit` — crash-safe append-only JSONL decision
  log with torn-tail quarantine recovery;
* :mod:`repro_torch.obs.timeline` — one estimate's memory timeline as
  Chrome-trace JSON (the batch hillclimb's ``--timeline-out``);
* :mod:`repro_torch.obs.ingest` — observed-peak residual ingestion
  (``python -m repro_torch.obs.ingest``).

:class:`Observability` bundles them behind one handle. The admission
service always owns one (``obs=`` kwarg, default *disabled*): the
metrics registry is live either way — it is the single source for the
service/daemon counters, so ``stats``, ``health`` and ``metrics``
kinds can never drift — while spans, correlation IDs and audit
records only activate when ``enabled=True``. Disabled instrumentation
costs one attribute check / ``ContextVar.get`` per hook site, and an
enabled run is bit-identical to a bare one by construction: observers
never feed back into decisions.
"""
from __future__ import annotations

from . import spans
from . import spans as _spans
from .audit import AuditLog
from .metrics import (Counter, CounterDict, Gauge, Histogram,
                      MetricsRegistry, parse_prometheus)
from .spans import (Span, Tracer, current_correlation_id, event,
                    mint_correlation_id, span)

__all__ = [
    "AuditLog", "Counter", "CounterDict", "Gauge", "Histogram",
    "MetricsRegistry", "Observability", "Span", "Tracer",
    "current_correlation_id", "event", "mint_correlation_id",
    "parse_prometheus", "span", "spans",
]


class Observability:
    """One handle bundling tracer + metrics registry + audit log."""

    def __init__(self, enabled: bool = True, *,
                 registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 audit_dir: str | None = None,
                 audit: AuditLog | None = None,
                 max_spans: int = 4096):
        self.enabled = bool(enabled)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else Tracer(max_spans=max_spans)
        if audit is not None:
            self.audit = audit
        elif audit_dir is not None:
            self.audit = AuditLog(audit_dir)
        else:
            self.audit = None

    def request(self, kind: str, job_id: str = "") -> "_RequestScope":
        """Per-request entry point: mints a correlation ID, installs
        the span context, and opens the root span. Yields the
        correlation ID (None when disabled)."""
        return _RequestScope(self, kind, job_id)

    def span(self, name: str, **attrs):
        """An explicit span on this handle's tracer (layers that hold
        the handle; deep layers use the module-level
        :func:`repro_torch.obs.spans.span` instead)."""
        if not self.enabled:
            return _spans._NOOP
        return self.tracer.span(name, **attrs)

    def record(self, kind: str, correlation_id: str | None = None,
               **fields) -> dict | None:
        """Append one audit record (no-op without an audit log)."""
        if self.audit is None:
            return None
        if correlation_id is None:
            correlation_id = current_correlation_id()
        return self.audit.append(
            {"kind": kind, "correlation_id": correlation_id,
             **fields})

    def to_chrome_trace(self) -> dict:
        return self.tracer.to_chrome_trace()

    def stats(self) -> dict:
        out = {"enabled": self.enabled,
               "spans": self.tracer.stats()}
        if self.audit is not None:
            out["audit"] = self.audit.stats()
        return out

    def close(self) -> None:
        if self.audit is not None:
            self.audit.close()


class _RequestScope:
    """Class-based per-request context (one per decision — cheaper
    than a ``contextlib`` generator pair): correlation ID + activated
    span context + root span when enabled, a no-op yielding None when
    disabled."""

    __slots__ = ("_act", "_span", "_cid")

    def __init__(self, obs: Observability, kind: str, job_id: str):
        if not obs.enabled:
            self._act = None
            self._cid = None
            return
        cid = mint_correlation_id()
        self._cid = cid
        self._act = _spans.activate(obs.tracer, cid)
        self._span = obs.tracer.span(f"service.{kind}",
                                     correlation_id=cid,
                                     job_id=job_id)

    def __enter__(self) -> str | None:
        if self._act is None:
            return None
        self._act.__enter__()
        self._span.__enter__()
        return self._cid

    def __exit__(self, *exc) -> bool:
        if self._act is not None:
            self._span.__exit__(*exc)
            self._act.__exit__(*exc)
        return False
