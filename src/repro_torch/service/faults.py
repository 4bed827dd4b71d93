"""Fault-injection harness for the admission service (a stdlib copy of
``repro.service.faults``).

A :class:`FaultPlan` is a declarative script of failures to inject at
named sites inside the serving stack. Production code calls
``plan.check(site)`` (or ``plan.check(site, path=...)`` for on-disk
sites) at well-defined points; the plan decides — per site, per hit
count — whether to raise, hang, or corrupt the artifact at ``path``.
With no plan attached every check is a no-op attribute test, so the
fault-free fast path stays bit-identical to the un-instrumented code.

Injection sites wired through the stack:

===============  ============================================================
site             fired from
===============  ============================================================
``tracer``       ``XMemEstimator._trace_phase`` — after a cache miss, right
                 before the fake-tensor trace (models a tracer exception or
                 hang on an exotic model)
``replay``       ``XMemEstimator._estimate_from_phases`` — before the
                 allocator replay (models a hung / crashed simulation)
``store.load``   ``TraceStore.load`` — before the entry file is read;
                 ``corrupt``/``truncate`` mangle the file on disk first,
                 exercising the quarantine path
``store.save``   ``TraceStore.save`` — after the atomic rename; ``corrupt``
                 /``truncate`` mangle the *persisted* entry (a simulated
                 mid-write crash surfaces at the next load)
``socket``       the admission daemon, once per parsed request line
``node.fail``    polled by the fleet simulator once per arrival tick
                 — permanently kills a node
``node.flap``    like ``node.fail`` but the node returns after
                 ``down_for`` ticks
``node.shrink``  multiplies a node's effective capacity by
                 ``shrink_frac`` (a partial-HBM loss / MIG re-slice)
===============  ============================================================

Fault kinds: ``raise`` (:class:`FaultError`, non-retryable — the
degradation ladder falls straight to the next rung), ``transient``
(:class:`TransientFaultError` — the ladder retries with backoff before
falling), ``hang`` (waits up to ``hang_s`` on the plan's cancel event;
a deadline abandons the rung, and ``FaultPlan.cancel()`` — called when
``inject_faults`` exits — wakes every stranded sleeper immediately),
``corrupt`` (overwrites a byte range of ``path``), ``truncate`` (cuts
``path`` to half its size), ``event`` (a fleet-level topology event at
one of the ``node.*`` sites above — consumed via :meth:`FaultPlan.poll`
by the fleet simulator, a no-op under :meth:`FaultPlan.check`). Used by
``tests/test_torch_faults.py`` and ``ClusterSimulator.replay(faults=...)``
chaos mode; the ``node.*`` sites stay valid names for the fleet
simulator, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Sequence

#: Fleet-topology event sites, polled (not checked) once per arrival
#: tick by the fleet simulator (``sched/``, not ported yet).
FLEET_SITES = ("node.fail", "node.flap", "node.shrink")


class FaultError(RuntimeError):
    """An injected, non-retryable failure."""


class TransientFaultError(FaultError):
    """An injected failure the caller may retry (backoff applies)."""


class ChaosSafetyViolation(AssertionError):
    """Chaos replay admitted a job whose true peak exceeds its device —
    the one outcome fault injection must never produce."""


@dataclasses.dataclass
class FaultSpec:
    """One scripted failure: fire ``times`` times at ``site``, skipping
    the first ``after`` hits. ``times=None`` fires on every hit.

    Fleet-event fields (``kind="event"`` at a ``node.*`` site): the
    fleet simulator polls each fleet site once per arrival tick, so
    ``after`` is the tick the event fires at. ``node`` names the target
    (None lets the scheduler pick the most-loaded node), ``down_for``
    is how many ticks a flapped node stays down, and ``shrink_frac``
    the capacity multiplier of a ``node.shrink``."""

    site: str                   # "tracer" | "replay" | "node.fail" | ...
    kind: str                   # "raise" | "transient" | "hang" | ... | "event"
    times: int | None = 1
    after: int = 0
    hang_s: float = 30.0
    message: str = ""
    node: str | None = None     # fleet events: target node id
    down_for: int = 2           # node.flap: ticks until the node returns
    shrink_frac: float = 0.5    # node.shrink: capacity multiplier

    _KINDS = ("raise", "transient", "hang", "corrupt", "truncate",
              "event")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {self._KINDS})")
        if self.site in FLEET_SITES and self.kind != "event":
            raise ValueError(
                f"fleet site {self.site!r} takes kind='event', "
                f"got {self.kind!r}")
        if self.kind == "event" and self.site not in FLEET_SITES:
            raise ValueError(
                f"kind='event' is only valid on fleet sites "
                f"{FLEET_SITES}, got site {self.site!r}")


def fleet_event(site: str, *, at: int = 0, node: str | None = None,
                down_for: int = 2, shrink_frac: float = 0.5,
                times: int | None = 1) -> FaultSpec:
    """Shorthand for a fleet-topology event: ``site`` is one of
    ``FLEET_SITES``, ``at`` the arrival tick it fires on."""
    if site not in FLEET_SITES:
        raise ValueError(f"{site!r} is not a fleet site {FLEET_SITES}")
    return FaultSpec(site=site, kind="event", times=times, after=at,
                     node=node, down_for=down_for,
                     shrink_frac=shrink_frac)


def _corrupt_file(path: str) -> None:
    """Overwrite a mid-file byte range with garbage (parse must fail)."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(max(size // 3, 0))
            f.write(b"\x00#corrupt#\x00" * 4)
    except OSError:
        pass


def _truncate_file(path: str) -> None:
    """Cut the file to half its size (a mid-write crash)."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
    except OSError:
        pass


class FaultPlan:
    """Thread-safe collection of :class:`FaultSpec`; counts every site
    hit and every fault actually fired (``stats()``)."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs = list(specs)
        self._lock = threading.Lock()
        self.hits: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        self._spec_fired = [0] * len(self.specs)
        # hang sleepers wait on this instead of time.sleep so an
        # exiting inject_faults scope can wake them immediately
        self._cancel = threading.Event()

    def arm(self) -> None:
        """Re-arm the plan for a fresh injection scope (clears a prior
        ``cancel`` so scripted hangs block again)."""
        self._cancel.clear()

    def cancel(self) -> None:
        """Wake every thread currently sleeping in an injected hang —
        called when the injection scope exits, so abandoned rung workers
        stop stranding threads for the full ``hang_s``."""
        self._cancel.set()

    def add(self, *specs: FaultSpec) -> "FaultPlan":
        with self._lock:
            self.specs.extend(specs)
            self._spec_fired.extend([0] * len(specs))
        return self

    def _select(self, site: str) -> FaultSpec | None:
        """Pick the first applicable spec for this hit (under lock)."""
        hit = self.hits.get(site, 0)
        self.hits[site] = hit + 1
        for i, spec in enumerate(self.specs):
            if spec.site != site or hit < spec.after:
                continue
            if spec.times is not None and self._spec_fired[i] >= spec.times:
                continue
            self._spec_fired[i] += 1
            self.fired[site] = self.fired.get(site, 0) + 1
            return spec
        return None

    def poll(self, site: str) -> FaultSpec | None:
        """Event-style selection: return the spec scheduled for this
        ``site`` hit (counting the hit) without raising or blocking —
        how the fleet simulator consumes ``node.*`` topology events."""
        with self._lock:
            return self._select(site)

    def check(self, site: str, path: str | None = None) -> None:
        """Fire any scripted fault for this ``site`` hit. File kinds
        need ``path``; without one they degrade to ``raise``."""
        with self._lock:
            spec = self._select(site)
        if spec is None or spec.kind == "event":
            return
        msg = spec.message or f"injected {spec.kind} at {site}"
        if spec.kind == "hang":
            # interruptible: wakes early when the injection scope exits
            self._cancel.wait(spec.hang_s)
            return
        if spec.kind in ("corrupt", "truncate"):
            if path is None:
                raise FaultError(msg + " (no path at this site)")
            (_corrupt_file if spec.kind == "corrupt"
             else _truncate_file)(path)
            return
        if spec.kind == "transient":
            raise TransientFaultError(msg)
        raise FaultError(msg)

    def stats(self) -> dict:
        with self._lock:
            return {"specs": len(self.specs), "hits": dict(self.hits),
                    "fired": dict(self.fired)}


def plan_raising_at(*sites: str, kind: str = "raise",
                    times: int | None = None) -> FaultPlan:
    """Shorthand for the common every-hit matrix rows in tests."""
    return FaultPlan([FaultSpec(site=s, kind=kind, times=times)
                      for s in sites])
