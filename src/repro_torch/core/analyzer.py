"""Analyzer — stage 2 of the xMem pipeline (paper §3.2).

Consumes the raw event stream and produces structured, attributed
``BlockLifecycle`` records:

* pairs alloc/free events into lifecycles (handling address reuse for
  external traces, where an address is recycled after a free);
* attributes each block to the operator / layer scope that produced it.
  For tracer-produced streams attribution is structural.
  For *external* traces (JSON event dumps without linkage) we keep the
  paper's time-window containment attribution as a fallback:
  a block belongs to an operator window if its whole lifespan falls
  inside the window, or it is allocated inside the window and persists
  beyond the linked component;
* classifies blocks (param/grad/activation/...) from scope markers —
  blocks the port's tracer records while the autograd engine runs get
  the scope ``backward`` (the JAX package's get ``transpose(...)``), the
  counterpart of the paper's seq-number fwd→bwd linking;
* aggregates per-layer footprints — the per-layer/operator profile the
  paper identifies as the foundation for distributed planning (§6.2).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Sequence

from .events import (TRACE_SCHEMA_VERSION, BlockKind, BlockLifecycle,
                     MemoryEvent, Trace, TraceSchemaError)


def load_trace(path: str) -> Trace:
    """Load a persisted trace dump for analysis.

    Delegates to ``Trace.load`` (which validates ``schema_version`` —
    dumps written by a newer tracer, or with an unknown payload format,
    raise :class:`TraceSchemaError` instead of mis-parsing) and wraps
    non-schema failures in the same error type with the analyzer's
    context attached, so callers get one clear failure mode.
    """
    try:
        return Trace.load(path)
    except TraceSchemaError:
        raise
    except (KeyError, ValueError, TypeError) as e:
        raise TraceSchemaError(
            f"{path}: not a valid xMem trace dump "
            f"(schema <= v{TRACE_SCHEMA_VERSION}): {e}") from e


def reconstruct_lifecycles(trace: Trace) -> list[BlockLifecycle]:
    """Pair alloc/free events into lifecycles (paper: 'reconstructed
    lifecycle entities'). Blocks lacking a free are persistent."""
    open_blocks: dict[int, MemoryEvent] = {}
    out: list[BlockLifecycle] = []
    for e in trace.events:
        if e.kind == "alloc":
            open_blocks[e.block_id] = e
        elif e.kind == "free":
            a = open_blocks.pop(e.block_id, None)
            if a is None:
                continue  # free without alloc: trace started mid-stream
            out.append(BlockLifecycle(
                a.block_id, a.size, a.t, e.t, a.iteration, a.phase,
                a.op, a.scope, a.block_kind, 1.0, a.shape, a.space))
    for a in open_blocks.values():  # persistent (no free observed)
        out.append(BlockLifecycle(
            a.block_id, a.size, a.t, None, a.iteration, a.phase,
            a.op, a.scope, a.block_kind, 1.0, a.shape, a.space))
    out.sort(key=lambda b: b.alloc_t)
    return out


def reconstruct_from_address_events(
        events: Sequence[dict]) -> list[BlockLifecycle]:
    """External-trace path: events carry ``addr`` (reused over time) rather
    than unique block ids — the exact problem the paper's Analyzer solves.
    Pairs by address while an address is live; reuse after free opens a
    new lifecycle."""
    live_addr: dict[int, tuple[int, dict]] = {}
    out: list[BlockLifecycle] = []
    next_id = 0
    for t, e in enumerate(sorted(events, key=lambda d: d["t"])):
        if e["kind"] == "alloc":
            live_addr[e["addr"]] = (next_id, {**e, "t": t})
            next_id += 1
        else:
            got = live_addr.pop(e["addr"], None)
            if got is None:
                continue
            bid, a = got
            out.append(BlockLifecycle(
                bid, a["size"], a["t"], t, a.get("iteration", 0),
                scope=a.get("scope", ""), op=a.get("op", "")))
    for bid, a in live_addr.values():
        out.append(BlockLifecycle(
            bid, a["size"], a["t"], None, a.get("iteration", 0),
            scope=a.get("scope", ""), op=a.get("op", "")))
    out.sort(key=lambda b: b.alloc_t)
    return out


@dataclasses.dataclass
class OpWindow:
    """An operator/component execution window for time-based attribution."""
    name: str
    start: int
    end: int
    component_end: int | None = None  # end of the linked high-level component


def attribute_by_time_window(blocks: Iterable[BlockLifecycle],
                             windows: Sequence[OpWindow]) -> list[BlockLifecycle]:
    """Paper §3.2 attribution fallback for traces without structural scopes.

    A block is attributed to window W if (i) its whole lifespan falls in W,
    or (ii) it is allocated in W and persists beyond W's linked component.
    Unattributed temporary blocks (allocated by higher-level script, not in
    any operator) are dropped — 'presumed less relevant for the target'.
    """
    ws = sorted(windows, key=lambda w: (w.start, -(w.end - w.start)))
    out = []
    for b in blocks:
        if b.scope:          # structural attribution already present
            out.append(b)
            continue
        owner = None
        for w in ws:
            if w.start <= b.alloc_t < w.end:
                end = b.free_t if b.free_t is not None else float("inf")
                comp_end = w.component_end if w.component_end is not None else w.end
                if end <= w.end or end > comp_end:
                    owner = w
                    # prefer the tightest (latest-starting) enclosing window
        if owner is not None:
            out.append(dataclasses.replace(b, scope=owner.name))
    return out


_BWD_MARKERS = ("transpose", "backward")

#: scope -> is-backward verdict memo; scope strings repeat heavily across
#: blocks (and are interned by the tracer), so the substring scans run
#: once per distinct scope instead of once per block
_BWD_SCOPE_MEMO: dict[str, bool] = {}


def _is_bwd_scope(scope: str) -> bool:
    v = _BWD_SCOPE_MEMO.get(scope)
    if v is None:
        v = _BWD_SCOPE_MEMO[scope] = any(m in scope for m in _BWD_MARKERS)
        if len(_BWD_SCOPE_MEMO) > 1 << 16:   # unbounded-growth guard
            _BWD_SCOPE_MEMO.clear()
    return v


def classify_blocks(blocks: Iterable[BlockLifecycle],
                    param_like_sizes: frozenset[int] = frozenset()
                    ) -> list[BlockLifecycle]:
    """Refine BlockKind using structural scope markers.

    * blocks born under a transpose scope are backward artifacts; those
      whose size matches a parameter are gradient candidates (the paper
      filters optimizer-state candidates by parameter-size match, §3.3(5));
    * everything else inside fwd/bwd keeps ACTIVATION.
    """
    out = []
    append = out.append
    _act, _tmp, _grad = BlockKind.ACTIVATION, BlockKind.TEMP, BlockKind.GRAD
    for b in blocks:
        bk = b.block_kind
        if ((bk is _act or bk is _tmp)
                and b.size in param_like_sizes
                and _is_bwd_scope(b.scope)):
            b = dataclasses.replace(b, block_kind=_grad)
        append(b)
    return out


def layer_report(blocks: Iterable[BlockLifecycle], depth: int = 2) -> dict:
    """Per-layer byte aggregation: {scope_prefix: {kind: bytes}}.

    This is the granular profile the paper names as the prerequisite for
    model/pipeline-parallel planning (§6.2); the distributed estimator and
    the sharding engine consume it.
    """
    rep: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for b in blocks:
        prefix = "/".join(b.scope.split("/")[:depth]) if b.scope else "<root>"
        rep[prefix][b.block_kind.value] += b.size
        rep[prefix]["count"] += 1
    return {k: dict(v) for k, v in rep.items()}


def phase_peaks(blocks: Sequence[BlockLifecycle]) -> dict:
    """Peak live bytes per phase — quick structural summary."""
    from .events import peak_live_bytes
    by_phase: dict[str, list[BlockLifecycle]] = defaultdict(list)
    for b in blocks:
        by_phase[b.phase.value].append(b)
    return {ph: peak_live_bytes(bs) for ph, bs in by_phase.items()}
