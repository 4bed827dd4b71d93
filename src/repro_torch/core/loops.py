"""Step-loop composition of phase traces: the port's counterpart of the
JAX package's capped unroll of the scans inside a layer.

The JAX package's tracer interprets every ``lax.scan`` for at most
``scan_unroll_cap`` iterations, the chunk scans and the step scans
nested in them (the sLSTM's, Mamba's, chunked attention's query and key
scans), so a trace costs a few steps at any sequence length; its capped
peak is an approximation. The port runs these scans as Python loops
(``models/steps.py``), so an eager trace pays for every step of every
chunk: in training each step is traced in the forward, in its period's
recompute and in its chunk's recompute, and its backward runs. This
module makes such a trace cost a few steps of a few chunks **exactly**,
as ``core/depth.py`` does for the layer stack, and with its machinery:

* **Levels.** A long loop (at least ``MIN_STEPS`` steps) inside a step
  of another long loop of at least ``NEST_MIN`` steps is at level 1,
  the others at level 0; a loop nested deeper than ``LEVELS`` runs
  every step. A long loop shorter than ``NEST_MIN`` runs every step once
  a long loop begins in it (nesting would cost more probes than it
  saves), and a shorter loop runs in full in every probe; neither
  nests anything. A loop's level is its call site's
  (``_StepHook.loop``), so the loop that a checkpoint's recompute runs
  again in the backward keeps it.
* **Probes.** The phase is traced with every long loop of level ``l``
  run for ``k_l`` of its steps (``PROBE_STEPS``: 6 or 7 at each level;
  the first ``k - 1`` steps and the last, so a last chunk shaped
  otherwise runs in every probe), the steps' outputs joined into the
  real shape (``models.steps.stack_steps``, ``cat_steps``), so nothing
  outside the loops changes shape: a probe differs from the full trace
  only by the steps it leaves out. One level takes two probes; two
  levels four, one for each ``(k_0, k_1)``.
* **Labels.** Each event gets, at each level, ``instance * k + step``
  (``_StepHook``): the step that runs in a forward (the model marks each
  step and the loop's end), or in the backward the step whose forward
  made the running autograd node (its sequence number between two
  marks), -1 outside the loops. A node that recomputes a checkpointed
  chunk labels the chunk's work outside the recomputed loop, and the
  rest of its own, -1 at the recomputed loop's level and deeper: the
  recompute's loop is a group of its own, inside the step of the outer
  loop that the node belongs to.
* **Structure and model.** ``depth._Probe`` cuts each probe into fixed
  segments and groups of step runs of one level (a loop instance's
  forward, a recompute of it, its backward in reverse) and
  ``depth._DepthModel`` fits them on the first probe, with ``EDGE`` =
  2: the first two and last two steps of a group have templates of
  their own (the last step's backward runs first and makes the gradient
  buffers the others add into, so its neighbour frees other blocks than
  a middle step; a shorter last chunk is the last step), and the middle
  steps share one template. Nothing outside the loops moves with ``k``,
  so one probe is enough to fit: every size is taken as constant, a
  free in an edge step that reaches an edge step names its block by
  that step's class (from the other end, a step that far is the
  count's), and a list of every step's outputs dying at once is one
  ``RUN`` of frees in a fixed segment, anchored to the group's ends.
* **Nesting.** Innermost first: for each ``k_0``, the level-1 loops are
  fitted on the probe at ``(k_0, 6)``, checked against ``(k_0, 7)`` and
  synthesized at their real step counts, the events' level-0 labels
  carried through; the level-0 loops are then fitted on the phase so
  made at ``k_0`` = 6, checked against the one at 7, and synthesized at
  their real chunk counts.
* **The check.** At each level the model must reproduce the second
  probe exactly (``depth.phases_equal``, and the carried labels: the
  outer levels', the units' when the phase is itself a depth probe):
  three middle steps side by side, each edge one step further from the
  other end, every constant at another ``k``. Every probe must run the
  same loops at that level and above. Then each group is synthesized at
  its loop's own step count (a shorter last chunk's inner loop is a loop
  of its own). Any failure traces the phase in full and says why.

The steps past the probes' are taken to repeat the middle ones, as the
layers past depth probes are; the model's loops run the same ops at
every step (a causal chunked attention runs every key chunk, the masked
ones too). Only the estimator's fast path composes
(``XMemEstimator._trace_phase``), a phase's trace in full or each of its
depth probes; a composed trace says so in ``meta["loops"]``: its
``source`` ("composed", "traced" when no loop is long enough,
"fallback" with ``why``), the real phase's loops, their ``signatures``
(``[steps, loops, level]``), the real ``steps`` (at every level) and
the ``steps_traced``, and the same counts for each level (``by_level``).
"""
from __future__ import annotations

import bisect
import collections
import time

import torch

from ..models.steps import STEP_MARKS, probe_steps
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
#: the nesting levels that compose (a chunk loop and the step loop in
#: each of its chunks); a long loop nested deeper runs every step
LEVELS = 2
#: a long loop nests the long loops in its steps when it has at least
#: this many; a shorter one runs every step, and the loops inside it
#: compose one level up. Nesting takes four probes where one level
#: takes two, each of which traces the rest of the phase again: with a
#: chunk loop of C chunks whose bodies cost b each and the rest of the
#: phase N, nesting costs 4 (N + 7 b) against 2 (N + C b), less when
#: C > 14 + N / b. On an H100 host's CPU (scripts/long_paths.py,
#: PERF.md section 6) nesting traced xlstm-1.3b's 8 layers, 16 chunks a
#: sLSTM beside 7 mLSTM layers, in 58.7 s against 36.3 s at one level,
#: and qwen3-32b's 4 layers at 32 query chunks in 66.0 s against 148.8 s
NEST_MIN = 32


class _Refused(Exception):
    """A composition refused; the message says why."""


class _Running:
    """A long loop running its forward in a probe: its level, steps,
    instance, and where it began (the events and marks so far); ``full``
    once it runs every step (``_StepHook._unnest``)."""

    def __init__(self, level, T, inst, site, n, marks):
        self.level, self.T, self.inst, self.site = level, T, inst, site
        self.n, self.marks, self.step, self.full = n, marks, 0, False


class _StepHook:
    """``STEP_MARKS.hook`` of one probe: each long loop of level ``l``
    runs ``ks[l]`` steps, and every event gets a label at each level,
    ``instance * k + step`` of its step there, -1 outside that level's
    loops.

    A forward event's step is the loop's step that runs. A backward
    event's is the step whose forward made the autograd node that runs
    (its sequence number falls between two marks), except in a node that
    recomputes a checkpointed chunk: its events outside the recomputed
    loop (the chunk's work before and after it, and the rest of the
    node's own) are outside the loops of that loop's level and deeper
    (``fixes``: the index ranges of the events labelled before the
    recompute began). A long loop shorter than ``NEST_MIN`` in whose
    first step a long loop begins runs every step from then on, its
    marks undone (``_unnest``), so the loops in it are a level up.
    ``loops`` holds each long loop's level, steps and the label of the
    outer step it runs in (-1 at level 0); ``why`` says why the probe's
    loops cannot compose."""

    def __init__(self, ks: tuple):
        self.ks = ks
        self.loops: list[tuple[int, int, int]] = []
        self.begun = [0] * LEVELS        # loops begun at each level
        self.site_level: dict = {}
        self.full_sites: set = set()     # loops that run every step
        self.why: str | None = None
        self.running: list[_Running] = []    # long loops running a forward
        self.current = [None] * LEVELS
        self.seq_starts: list[int] = []
        self.seq_labels: list[tuple] = []
        self.n = 0                       # events labelled so far
        self.node_seq = None             # the running node's, and
        self.node_start = 0              # its first event
        self.recomputing = [None] * LEVELS   # a node that recomputed a loop
        self.fixes: list[list] = [[] for _ in range(LEVELS)]

    def _mark(self, level: int, label) -> None:
        # the labels of the autograd nodes made from now on: a loop's
        # forward makes the nodes the backward runs (a recompute's are
        # never run)
        self.current[level] = label
        self.seq_starts.append(torch._C._autograd._get_sequence_nr())
        self.seq_labels.append(tuple(-1 if c is None else c
                                     for c in self.current))

    def _unnest(self, outer: _Running) -> None:
        """``outer``, in its first step, runs every step from now on:
        its record, its first step's labels and its marks undone."""
        if outer.step:
            self.why = "levels"          # a long loop past its first step
        self.running.pop()
        self.loops.pop()
        self.begun[outer.level] -= 1
        self.full_sites.add(outer.site)
        self.current[outer.level] = None
        self.fixes[outer.level].append((outer.n, self.n))
        for i in range(outer.marks, len(self.seq_labels)):
            lab = list(self.seq_labels[i])
            lab[outer.level] = -1
            self.seq_labels[i] = tuple(lab)
        outer.full = True

    def loop(self, T: int, site):
        if T < MIN_STEPS or site in self.full_sites:
            yield from range(T)
            return
        if self.running and self.running[-1].T < NEST_MIN:
            self._unnest(self.running[-1])
        node = torch._C._current_autograd_node() \
            if torch._C._current_graph_task_id() != -1 else None
        if self.running or node is None:
            level = len(self.running)
            if self.site_level.setdefault(site, level) != level:
                self.why = "levels"
        else:                            # a recompute in the backward
            level = self.site_level.get(site)
            if level is None:
                self.why, level = "levels", 0
        if level >= LEVELS:
            yield from range(T)
            return
        parent = self.now()[level - 1] if level else -1
        if level and parent < 0:
            self.why = "levels"
        k = self.ks[level]
        inst = self.begun[level]
        self.begun[level] += 1
        self.loops.append((level, T, parent))
        if node is not None and not self.running:
            seq = node._sequence_nr()
            for lv in range(level, LEVELS):
                if seq != self.recomputing[lv]:
                    if seq == self.node_seq:
                        self.fixes[lv].append((self.node_start, self.n))
                    self.recomputing[lv] = seq
        me = _Running(level, T, inst, site, self.n, len(self.seq_labels))
        self.running.append(me)
        steps = probe_steps(T, k)
        try:
            while me.step < len(steps):
                if not me.full:
                    self._mark(level, inst * k + me.step)
                yield steps[me.step]
                if me.full:
                    steps = range(T)
                me.step += 1
        finally:
            if not me.full:
                self.running.pop()
                self._mark(level, None)

    def __call__(self) -> tuple:
        i = self.n
        self.n += 1
        if not self.running and torch._C._current_graph_task_id() != -1:
            node = torch._C._current_autograd_node()
            if node is not None and node._sequence_nr() != self.node_seq:
                self.node_seq, self.node_start = node._sequence_nr(), i
        return self.now()

    def now(self) -> tuple:
        """The labels, at each level, of the event that happens now."""
        cur = self.current
        if None not in cur:
            return tuple(cur)
        if torch._C._current_graph_task_id() == -1:
            return tuple(-1 if c is None else c for c in cur)
        node = torch._C._current_autograd_node()
        if node is None:
            return tuple(depth._UNLABELLED if c is None else c for c in cur)
        seq = node._sequence_nr()
        j = bisect.bisect_right(self.seq_starts, seq) - 1
        mark = self.seq_labels[j] if j >= 0 else (-1,) * LEVELS
        return tuple(c if c is not None
                     else -1 if seq == self.recomputing[lv] else mark[lv]
                     for lv, c in enumerate(cur))

    def label(self) -> int:
        """Non-negative for an event inside a long loop."""
        return max(self.now())

    def labels(self, labels, level: int) -> list:
        """The tracer's step labels at ``level``, the fixes applied."""
        out = [lab[level] for lab in labels]
        for s, e in self.fixes[level]:
            out[s:e] = [-1] * (e - s)
        return out


def _real_loops(hook: _StepHook) -> list:
    """Each level's loops in the real phase, as a counter of their step
    counts: a loop inside an outer loop's step stands for that step's
    real repeats (one for an edge step, the real count's middle steps
    for the first middle step of a probe, none for the others)."""
    weights: list[int] = []
    at_level: list[list[int]] = [[] for _ in range(LEVELS)]
    real = [collections.Counter() for _ in range(LEVELS)]
    for i, (lv, T, parent) in enumerate(hook.loops):
        w = 1
        if lv and parent >= 0:
            k = hook.ks[lv - 1]
            p, u = divmod(parent, k)
            outer = at_level[lv - 1][p]
            if depth._cls(u, k, EDGE) == (EDGE, EDGE):
                w = hook.loops[outer][1] - 2 * EDGE if u == EDGE else 0
            w *= weights[outer]
        weights.append(w)
        at_level[lv].append(i)
        real[lv][T] += w
    return real


def compose_steps(trace, unit_labeller=None):
    """The phase that ``trace(step_labeller, unit_labeller)`` traces,
    its long step loops composed from probes, or traced in full.
    ``unit_labeller`` is a depth probe's (``depth._UnitLabels``, reset
    before each trace), whose labels the synthesis carries. Returns
    ``(phase, unit labels, loop info)``: the info's ``source``
    ("composed", "traced", "fallback" and ``why``), ``loops``,
    ``signatures``, ``steps``, ``steps_traced``, ``by_level``, the
    ``probes`` traced, their seconds (``probe_s``) and the synthesis's
    (``synth_s``)."""
    info: dict = {"source": "traced", "loops": 0, "signatures": [],
                  "steps": 0, "steps_traced": 0, "probes": 0,
                  "probe_s": 0.0, "synth_s": 0.0}
    raw: dict = {}
    t0 = time.perf_counter()

    def probe(ks: tuple):
        """The trace at ``ks`` steps a level, its hook and its tracer."""
        ks = ks + (PROBE_STEPS[0],) * (LEVELS - len(ks))
        if ks not in raw:
            t = time.perf_counter()
            hook = _StepHook(ks)
            if unit_labeller is not None:
                unit_labeller.reset()
            prev = getattr(STEP_MARKS, "hook", None)
            STEP_MARKS.hook = hook
            try:
                entry, tr = trace(hook, unit_labeller)
            finally:
                STEP_MARKS.hook = prev
            raw[ks] = (entry, hook, tr)
            info["probe_s"] += time.perf_counter() - t
            if hook.loops:
                info["probes"] += 1
                for lv, _T, _p in hook.loops:
                    if lv < len(info["by_level"]):
                        info["by_level"][lv]["steps_traced"] += ks[lv]
        return raw[ks]

    def refused(why: str, level: int) -> _Refused:
        """A refusal at ``level``, named when loops nest."""
        return _Refused(why + (f", level {level}" if levels > 1 else ""))

    def level_probe(level: int, prefix: tuple, k: int):
        """The phase at ``prefix + (k,)`` steps a level with the loops
        below ``level`` composed, as a probe of ``level``'s loops, and
        its hook."""
        ks = prefix + (k,)
        if level + 1 < levels:
            entry, carried = compose_level(level + 1, ks)
            hook = probe(ks)[1]
            labels = [c[-1] for c in carried]
            extra = [c[:-1] for c in carried]
        else:
            entry, hook, tr = probe(ks)
            if hook.why or any(lp[0] >= levels for lp in hook.loops):
                raise refused(hook.why or "levels", level)
            per = [hook.labels(tr.step_labels, lv) for lv in range(levels)]
            units = tr.labels if unit_labeller is not None \
                else [None] * len(per[0])
            labels = per[level]
            extra = list(zip(units, *per[:level]))
        p = depth._Probe.parse(k, entry, labels, extra, edge=EDGE)
        if p is None:
            raise refused(f"structure at {k} steps", level)
        return p, hook, extra

    def compose_level(level: int, prefix: tuple):
        """The phase at ``prefix`` steps a level above ``level``, the
        loops of ``level`` and below at their real step counts, and each
        event's carried labels (its unit's, then each outer level's)."""
        subs = [level_probe(level, prefix, k) for k in PROBE_STEPS]
        own = [[lp for lp in h.loops if lp[0] <= level]
               for _p, h, _e in subs]
        if own[0] != own[1]:
            raise refused("loops", level)
        steps = [T for lv, T, _p in own[0] if lv == level]
        model = depth._DepthModel(subs[0][0])
        if not model.ok:
            raise refused("fit", level)
        k = PROBE_STEPS[-1]
        check = model.synthesize(k, [k] * len(model.groups))
        if check is None \
                or not depth.phases_equal(check[0], subs[-1][0].entry) \
                or check[1] != subs[-1][2]:
            raise refused(f"check at {k} steps", level)
        out = model.synthesize(k, [steps[p] for p, _d in model.groups])
        if out is None:
            raise refused("synthesis", level)
        return out

    info["by_level"] = [{"loops": 0, "steps": 0, "steps_traced": 0}
                        for _ in range(LEVELS)]
    entry, hook, tr = probe(())
    if not hook.loops:
        del info["by_level"]
        return entry, tr.labels, info
    levels = 1 + max(lv for lv, _T, _p in hook.loops)
    del info["by_level"][levels:]
    sig = []
    for lv, real in enumerate(_real_loops(hook)[:levels]):
        by = info["by_level"][lv]
        by["loops"] = sum(real.values())
        by["steps"] = sum(T * n for T, n in real.items())
        sig.extend([T, n, lv] for T, n in sorted(real.items()) if n)
    info["signatures"] = sig
    info["loops"] = sum(by["loops"] for by in info["by_level"])
    info["steps"] = sum(by["steps"] for by in info["by_level"])
    try:
        if hook.why:
            raise _Refused(hook.why)
        out, carried = compose_level(0, ())
    except _Refused as e:
        return _fallback(trace, unit_labeller, info, str(e))
    info["steps_traced"] = sum(by["steps_traced"]
                               for by in info["by_level"])
    info["source"] = "composed"
    info["synth_s"] = time.perf_counter() - t0 - info["probe_s"]
    out.trace.meta["loops"] = dict(info)
    return out, [c[0] for c in carried], info


def _fallback(trace, unit_labeller, info, why):
    """The phase traced in full after a refused composition."""
    info["why"] = why
    info["source"] = "fallback"
    if unit_labeller is not None:
        unit_labeller.reset()
    entry, tr = trace(None, unit_labeller)
    for by in info["by_level"]:
        by["steps_traced"] += by["steps"]
    info["steps_traced"] = sum(by["steps_traced"]
                               for by in info["by_level"])
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
        sig.update({(int(t), lv): n for t, n, lv in i["signatures"]})
    by_level: list[dict] = []
    used_ids = {id(i) for i in used}
    for i in infos:
        for lv, by in enumerate(i.get("by_level", ())):
            if lv == len(by_level):
                by_level.append({"loops": 0, "steps": 0, "steps_traced": 0})
            by_level[lv]["steps_traced"] += by["steps_traced"]
            if id(i) in used_ids:
                by_level[lv]["loops"] += by["loops"]
                by_level[lv]["steps"] += by["steps"]
    out.update(loops=sum(i["loops"] for i in used),
               signatures=[[t, n, lv] for (t, lv), n in sorted(
                   sig.items(), key=lambda x: (x[0][1], x[0][0]))],
               steps=sum(i["steps"] for i in used),
               steps_traced=sum(i["steps_traced"] for i in infos),
               by_level=by_level,
               probes=sum(i["probes"] for i in infos),
               probe_s=sum(i["probe_s"] for i in infos),
               synth_s=sum(i["synth_s"] for i in infos))
    if composed_depth:
        out["in"] = "depth probes"
    return out


def note(summary: dict) -> str:
    """A depth summary's step-loop composition (``depth.summary``) as
    the command lines print it beside the depth's: empty for a step
    without long loops; the levels when loops nest."""
    lp = summary.get("loops")
    if not lp:
        return ""
    why = f" ({lp['why']})" if "why" in lp else ""
    levels = f", {lp['levels']} levels" if lp.get("levels", 1) > 1 else ""
    return (f", loops {lp['source']}{why}: {lp['steps_traced']:,} of "
            f"{lp['steps']:,} steps traced{levels}")
