"""Step-loop composition of phase traces: the port's counterpart of the
JAX package's capped unroll of the scans inside a layer.

The JAX package's tracer interprets every ``lax.scan`` for at most
``scan_unroll_cap`` iterations, the step scans nested in a layer's
checkpointed chunk scans too (the sLSTM's, Mamba's), so a trace costs a
few steps at any sequence length; its capped peak is an approximation.
The port's sLSTM and Mamba blocks run a Python loop over each chunk's
steps (``models/steps.py``), so an eager trace pays for every step: in
training each step is traced in the forward, in its period's recompute
and in its chunk's recompute, and its backward runs. This module makes
such a trace cost a few steps **exactly**, as ``core/depth.py`` does for
the layer stack, and with its machinery:

* **Probes.** The phase is traced twice with every loop of at least
  ``MIN_STEPS`` steps run for ``k`` of them (``PROBE_STEPS``: 6 and
  7), the steps' outputs stacked into the real shape
  (``models.steps.stack_steps``), so nothing outside the loops changes
  shape: a probe differs from the full trace only by the steps it
  leaves out. A shorter loop runs in full in every probe.
* **Labels.** Each event gets ``instance * k + step`` (``_StepHook``):
  the step that runs in a forward (the model marks each step and the
  loop's end), or in the backward the step whose forward made the
  running autograd node (its sequence number between two marks), -1
  outside the loops. A node that recomputes a checkpointed chunk labels
  the chunk's work outside the recomputed loop, and the rest of its
  own, -1 too: the recompute's loop is a group of its own.
* **Structure and model.** ``depth._Probe`` cuts each probe into fixed
  segments and groups of step runs (a loop instance's forward, a
  recompute of it, its backward in reverse) and ``depth._DepthModel``
  fits them on the first probe, with ``EDGE`` = 2: the first two and
  last two steps of a group have templates of their own (the last
  step's backward runs first and makes the gradient buffers the others
  add into, so its neighbour frees other blocks than a middle step), and
  the middle steps share one template. Nothing outside the loops moves
  with ``k``, so one probe is enough to fit: every size is taken as
  constant, a free in an edge step that reaches an edge step names its
  block by that step's class (from the other end, a step that far is
  the count's), and a list of every step's outputs dying at once is one
  ``RUN`` of frees in a fixed segment, anchored to the group's ends.
* **The check.** The model must reproduce the second probe exactly
  (``depth.phases_equal``, and the unit labels when the phase is itself
  a depth probe): three middle steps side by side, each edge one step
  further from the other end, every constant at another ``k``. Every
  probe must run the same loops. Then each group is synthesized at its
  loop's own step count (a shorter last chunk of Mamba's is a loop of
  its own). Any failure traces the phase in full and says why.

The steps past the probes' are taken to repeat the middle ones, as the
layers past depth probes are; the model's loops run the same ops at
every step. Only the estimator's fast path composes
(``XMemEstimator._trace_phase``), a phase's trace in full or each of its
depth probes; a composed trace says so in ``meta["loops"]``: its
``source`` ("composed", "traced" when no loop is long enough,
"fallback" with ``why``), the loops composed, their ``signatures``
(``[steps, loops]``), the real ``steps`` and the ``steps_traced``.
"""
from __future__ import annotations

import bisect
import collections
import time

import torch

from ..models.steps import STEP_MARKS
from . import depth

#: the step counts the probes run each long loop for: the model is
#: fitted on the first (two edge steps at each end, two middle steps) and
#: must reproduce the second (three middle steps). At 6 an edge step is 3
#: or more from the other end's, so a reference to a step up to 2 away
#: reaches a middle step or an edge step at its own end
PROBE_STEPS = (6, 7)
#: a loop composes when the probes together run fewer of its steps
MIN_STEPS = sum(PROBE_STEPS) + 1
#: the units at each end of a group with templates of their own
EDGE = 2


class _StepHook:
    """``STEP_MARKS.hook`` of one probe: each loop of at least
    ``MIN_STEPS`` steps runs ``k``, and every event gets the label
    ``instance * k + step`` of its step, -1 outside the long loops.

    A forward event's step is the loop's step that runs. A backward
    event's is the step whose forward made the autograd node that runs
    (its sequence number falls between two marks), except in a node that
    recomputes a checkpointed chunk: its events outside the recomputed
    loop (the chunk's work before and after it, and the rest of the
    node's own) are outside the loops (``fixes``: the index ranges of
    the events labelled before the recompute began)."""

    def __init__(self, k: int):
        self.k = k
        self.steps: list[int] = []       # each instance's real step count
        self.current = None
        self.seq_starts: list[int] = []
        self.seq_labels: list[int] = []
        self.n = 0                       # events labelled so far
        self.node_seq = None             # the running node's, and
        self.node_start = 0              # its first event
        self.recomputing = None          # a node that recomputed a loop
        self.fixes: list[tuple[int, int]] = []

    def _mark(self, label) -> None:
        self.seq_starts.append(torch._C._autograd._get_sequence_nr())
        self.seq_labels.append(-1 if label is None else label)
        self.current = label

    def loop(self, T: int):
        if T < MIN_STEPS:
            yield from range(T)
            return
        inst = len(self.steps)
        self.steps.append(T)
        if torch._C._current_graph_task_id() != -1:
            node = torch._C._current_autograd_node()
            if node is not None:
                seq = node._sequence_nr()
                if seq == self.node_seq and seq != self.recomputing:
                    self.fixes.append((self.node_start, self.n))
                self.recomputing = seq
        try:
            for t in range(self.k):
                self._mark(inst * self.k + t)
                yield t
        finally:
            self._mark(None)

    def __call__(self) -> int:
        i = self.n
        self.n += 1
        if self.current is None \
                and torch._C._current_graph_task_id() != -1:
            node = torch._C._current_autograd_node()
            if node is not None and node._sequence_nr() != self.node_seq:
                self.node_seq, self.node_start = node._sequence_nr(), i
        return self.label()

    def label(self) -> int:
        """The step the event that happens now belongs to."""
        if self.current is not None:
            return self.current
        if torch._C._current_graph_task_id() == -1:
            return -1
        node = torch._C._current_autograd_node()
        if node is None:
            return depth._UNLABELLED
        seq = node._sequence_nr()
        if seq == self.recomputing:
            return -1
        j = bisect.bisect_right(self.seq_starts, seq) - 1
        return -1 if j < 0 else self.seq_labels[j]

    def labels(self, labels) -> list:
        """The tracer's step labels with the fixes applied."""
        labels = list(labels)
        for s, e in self.fixes:
            labels[s:e] = [-1] * (e - s)
        return labels


def compose_steps(trace, unit_labeller=None):
    """The phase that ``trace(step_labeller, unit_labeller)`` traces,
    its long step loops composed from two probes, or traced in full.
    ``unit_labeller`` is a depth probe's (``depth._UnitLabels``, reset
    before each trace), whose labels the synthesis carries. Returns
    ``(phase, unit labels, loop info)``: the info's ``source``
    ("composed", "traced", "fallback" and ``why``), ``loops``,
    ``signatures``, ``steps``, ``steps_traced``, the ``probes`` traced,
    their seconds (``probe_s``) and the synthesis's (``synth_s``)."""
    info: dict = {"source": "traced", "loops": 0, "signatures": [],
                  "steps": 0, "steps_traced": 0, "probes": 0,
                  "probe_s": 0.0, "synth_s": 0.0}
    probes = []
    hooks = []
    unit_labels = []
    t0 = time.perf_counter()
    for k in PROBE_STEPS:
        hook = _StepHook(k)
        if unit_labeller is not None:
            unit_labeller.reset()
        prev = getattr(STEP_MARKS, "hook", None)
        STEP_MARKS.hook = hook
        try:
            entry, tr = trace(hook, unit_labeller)
        finally:
            STEP_MARKS.hook = prev
        if not hook.steps:
            return entry, tr.labels, info
        info["probes"] += 1
        info["steps_traced"] += k * len(hook.steps)
        hooks.append(hook)
        unit_labels.append(tr.labels)
        probes.append(depth._Probe.parse(
            k, entry, hook.labels(tr.step_labels),
            None if unit_labeller is None else tr.labels, edge=EDGE))
        if probes[-1] is None:
            return _fallback(trace, unit_labeller, info,
                             f"structure at {k} steps", t0)
    t1 = time.perf_counter()
    info["probe_s"] = t1 - t0
    steps = hooks[0].steps
    info["loops"] = len(steps)
    info["steps"] = sum(steps)
    info["signatures"] = [list(x) for x in
                          sorted(collections.Counter(steps).items())]
    if any(h.steps != steps for h in hooks):
        return _fallback(trace, unit_labeller, info, "loops", t0)
    model = depth._DepthModel(probes[0])
    if not model.ok:
        return _fallback(trace, unit_labeller, info, "fit", t0)
    k = PROBE_STEPS[-1]
    check = model.synthesize(k, [k] * len(model.groups))
    if check is None or not depth.phases_equal(check[0], probes[-1].entry) \
            or (unit_labeller is not None
                and check[1] != list(unit_labels[-1])):
        return _fallback(trace, unit_labeller, info, f"check at {k} steps",
                         t0)
    out = model.synthesize(k, [steps[p] for p, _d in model.groups])
    if out is None:
        return _fallback(trace, unit_labeller, info, "synthesis", t0)
    info["source"] = "composed"
    info["synth_s"] = time.perf_counter() - t1
    out[0].trace.meta["loops"] = dict(info)
    return out[0], out[1], info


def _fallback(trace, unit_labeller, info, why, t0):
    """The phase traced in full after a refused composition."""
    info["why"] = why
    info["source"] = "fallback"
    info["probe_s"] = time.perf_counter() - t0
    if unit_labeller is not None:
        unit_labeller.reset()
    entry, tr = trace(None, unit_labeller)
    info["steps_traced"] += info["steps"]
    return entry, tr.labels, info


def merge_loops(infos: list[dict], composed_depth: bool) -> dict:
    """One phase's loop composition from its traces' (``infos``): the
    depth probes' when the phase was composed by depth (their loops
    stand for the real depth's), else the last trace's; the probes and
    the steps traced are every trace's."""
    used = infos if composed_depth else infos[-1:]
    why = [i["why"] for i in used if "why" in i]
    sources = {i["source"] for i in used}
    out = {"source": "fallback" if why else "composed"
           if "composed" in sources else "traced"}
    if why:
        out["why"] = why[0]
    sig: collections.Counter = collections.Counter()
    for i in used:
        sig.update(dict((int(t), n) for t, n in i["signatures"]))
    out.update(loops=sum(i["loops"] for i in used),
               signatures=[list(x) for x in sorted(sig.items())],
               steps=sum(i["steps"] for i in used),
               steps_traced=sum(i["steps_traced"] for i in infos),
               probes=sum(i["probes"] for i in infos),
               probe_s=sum(i["probe_s"] for i in infos),
               synth_s=sum(i["synth_s"] for i in infos))
    if composed_depth:
        out["in"] = "depth probes"
    return out


def note(summary: dict) -> str:
    """A depth summary's step-loop composition (``depth.summary``) as
    the command lines print it beside the depth's: empty for a step
    without long loops."""
    lp = summary.get("loops")
    if not lp:
        return ""
    why = f" ({lp['why']})" if "why" in lp else ""
    return (f", loops {lp['source']}{why}: {lp['steps_traced']} of "
            f"{lp['steps']} steps traced")
