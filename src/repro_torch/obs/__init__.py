"""Observability for the PyTorch port: tracing spans only.

:mod:`repro_torch.obs.spans` is a copy of the JAX package's stdlib-only
span tracer (context-manager spans with correlation IDs, exportable as
Chrome-trace JSON). The estimator and simulator open spans through it;
metrics, audit and timelines come with the admission service.
"""
from __future__ import annotations

from . import spans
from .spans import (Span, Tracer, current_correlation_id, event,
                    mint_correlation_id, span)

__all__ = ["spans", "Span", "Tracer", "current_correlation_id", "event",
           "mint_correlation_id", "span"]
