"""Observability for the PyTorch port: tracing spans and timelines.

:mod:`repro_torch.obs.spans` is a copy of the JAX package's stdlib-only
span tracer (context-manager spans with correlation IDs, exportable as
Chrome-trace JSON); the estimator and simulator open spans through it.
:mod:`repro_torch.obs.timeline` is a copy of its memory-timeline export
(one estimate's composition as Chrome-trace JSON), which the batch
hillclimb writes with ``--timeline-out``. Metrics, audit and ingest come
with the admission service.
"""
from __future__ import annotations

from . import spans
from .spans import (Span, Tracer, current_correlation_id, event,
                    mint_correlation_id, span)

__all__ = ["spans", "Span", "Tracer", "current_correlation_id", "event",
           "mint_correlation_id", "span"]
