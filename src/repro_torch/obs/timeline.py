"""Memory-timeline export (a stdlib copy of ``repro.obs.timeline``).

Renders the simulated allocator demand curve and the top-K block
lifecycles from an :class:`~repro_torch.core.estimator.EstimateReport`
as a Chrome-trace / Perfetto JSON document:

* one **counter track** ("C" events) per memory space, sampled from
  the replay's ``(t, allocated, reserved)`` curve — timestamps are
  allocator event ticks, which Perfetto renders as microseconds;
* the K largest blocks as **slice tracks** ("X" events), labeled with
  kind/phase/op/space so a rejected dry run hands the user an
  inspectable picture of *what* owned the peak, not just a number.

Pure functions over report objects — no observability context needed.
"""
from __future__ import annotations

import json
import os


def _flatten_blocks(composition) -> list:
    """``report.composition`` is ``PeriodicBlocks`` (prefix/cycle/
    suffix) on the fast path, a flat block list on the reference
    path, or absent; normalize to one list."""
    if composition is None:
        return []
    if isinstance(composition, (list, tuple)):
        return list(composition)
    blocks = []
    for part in ("prefix", "cycle", "suffix", "blocks"):
        seg = getattr(composition, part, None)
        if seg:
            blocks.extend(seg)
    return blocks


def _block_size(block) -> int:
    for attr in ("sharded_size", "size"):
        v = getattr(block, attr, None)
        if v is not None:
            return int(v)
    return 0


def timeline_events(report, top_k: int = 20) -> dict:
    """Build the Chrome-trace document for one estimate report."""
    events = []
    sim = getattr(report, "sim", None)
    curve = list(getattr(sim, "curve", None) or ())
    for t, allocated, reserved in curve:
        events.append({
            "name": "memory", "ph": "C", "pid": 0, "tid": 0,
            "ts": t, "args": {"allocated": allocated,
                              "reserved": reserved}})
    stats = getattr(sim, "stats", None) or {}
    space_peaks = stats.get("space_peaks") or {}
    horizon = curve[-1][0] if curve else 0
    for space, peak in space_peaks.items():
        events.append({
            "name": f"peak[{space}]", "ph": "C", "pid": 0, "tid": 0,
            "ts": horizon, "args": {"peak_bytes": peak}})

    blocks = _flatten_blocks(getattr(report, "composition", None))
    top = sorted(blocks, key=_block_size, reverse=True)[:top_k]
    if top:
        ends = [getattr(b, "free_t", None) for b in top]
        horizon = max([horizon] +
                      [e for e in ends if e is not None] +
                      [getattr(b, "alloc_t", 0) for b in top])
    for i, b in enumerate(top):
        alloc_t = getattr(b, "alloc_t", 0)
        free_t = getattr(b, "free_t", None)
        kind = getattr(b, "block_kind", None)
        events.append({
            "name": f"{getattr(kind, 'value', kind) or 'block'}:"
                    f"{getattr(b, 'op', '') or getattr(b, 'scope', '')}",
            "ph": "X", "pid": 0, "tid": i + 1, "ts": alloc_t,
            "dur": max(0, (free_t if free_t is not None else horizon)
                       - alloc_t),
            "args": {
                "bytes": _block_size(b),
                "phase": str(getattr(b, "phase", "")),
                "scope": str(getattr(b, "scope", "")),
                "space": str(getattr(b, "space", "")),
            }})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {
                "peak_bytes": getattr(report, "peak_bytes", None),
                "persistent_bytes": getattr(report, "persistent_bytes",
                                            None),
                "curve_points": len(curve),
                "blocks_rendered": len(top),
                "blocks_total": len(blocks)}}


def write_timeline(report, path: str, top_k: int = 20) -> str:
    """Write the Perfetto artifact for ``report`` to ``path``
    (atomically) and return the path."""
    doc = timeline_events(report, top_k=top_k)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
