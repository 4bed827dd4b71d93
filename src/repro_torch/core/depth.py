"""Depth composition of phase traces: the port's counterpart of the JAX
package's bounded scan unroll.

The JAX package's tracer interprets a ``lax.scan`` over the layer stack
for at most ``scan_unroll_cap`` iterations and preallocates the stacked
outputs, so a trace costs a few layers at any depth. The port's model
loops over its layers in Python, so an eager trace pays for every
layer. This module gives it the same property: a phase whose step has a
:class:`DepthPlan` is traced at a few unit counts (``PROBE_UNITS``) and
its trace at the real depth is synthesized **exactly**, or the phase is
traced at the real depth for real. Nothing is ever approximated.

* **The repeating unit** is ``models.model.repeat_unit``: one layer of a
  plain dense stack, ``global_every`` layers of gemma3 (the remainder a
  suffix of local layers), one dense+MoE pair, one hybrid or SSM period.
* **Labels.** While a probe traces, the model calls ``UNIT_MARKS.fn`` before
  each unit and after the last, and every event gets a label
  (``_UnitLabels``): the unit whose forward runs, or, while the autograd
  engine runs, the unit whose forward made the node it is running (its
  sequence number falls between two marks), recomputed forwards
  included; -1 outside the stack.
* **Structure.** A probe's stream is fixed segments ``F_0 .. F_m`` with a
  group between each two: the runs of every unit of one pass in one
  direction (a forward's units in order, a backward's in reverse; one
  forward and one backward group per microbatch). Each unit run is the
  template of its class: the first unit, the last, or the middle ones.
  A free names its block by where the alloc was: a fixed segment and an
  offset, or a unit run, as a step ``u' - u`` from the freeing unit (or
  as the first or last unit, from a fixed segment) and the alloc's name
  in the run: its op, scope, kind and rank, and how many such allocs
  came before it there. A name, not an offset, so a reference made to a
  middle unit resolves in a first or last unit's run, which has allocs
  of its own (the last unit's backward makes the stacked gradients).
* **The model.** Fitted on the first two probes: every fixed segment
  and first and last run has the same events at both, and its sizes and
  shape dims are integer-affine in the unit count (the stacked ``[L,
  ...]`` parameters, cache and gradients make them so); a middle run is
  taken as it is. Every other column follows: block ids number the
  allocs in order, ``t`` is the position, a free's size, scope, kind
  and shape are its block's.
* **The check.** The model must reproduce the third probe's
  ``TracedPhase`` exactly (every trace column, the lifecycles, the input
  and output blocks, the abstract outputs), and the synthesized inputs
  must be the real depth's. Any failure traces the real depth in full.

A composed phase's trace says so in ``meta["depth"]``: its ``source``
(``"composed"``; ``"traced"`` for a full trace at a depth of no more
units than the probes trace together, 9; ``"fallback"`` for a full
trace after a refused composition, with ``why``), the units of the real
depth, and the units traced to make it.
The optimizer phases loop over leaves, not layers, and are not composed.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from .cache import BlockInfo, TracedPhase
from .events import (KIND_CODE, KIND_TABLE, BlockKind, BlockLifecycle,
                     ColumnarTrace, PHASE_TABLE, StringInterner, Trace)
from .tracer import aval_bytes

#: the unit counts the probes trace. The model is fitted on the first two
#: and must reproduce the third. A stack's first and last units differ
#: from the middle ones (the last unit's backward runs first and makes
#: the stacked gradients), so the fit needs a probe with a middle unit,
#: and the check one with two.
PROBE_UNITS = (2, 3, 4)

_UNLABELLED = -2


@dataclasses.dataclass(frozen=True)
class DepthPlan:
    """How a step is traced at another depth: its config, the step for
    another config (``make(cfg)``) and the step's argument trees at a
    config's depth from the trees at this one (``resize(cfg, trees)``)."""

    cfg: ModelConfig
    make: Callable[[ModelConfig], Callable]
    resize: Callable[[ModelConfig, list], list]

    @property
    def units(self) -> int:
        return _model().repeat_unit(self.cfg)[0]

    def at(self, n: int) -> ModelConfig:
        """The config with ``n`` units and the same remainder."""
        _, unit, rem = _model().repeat_unit(self.cfg)
        return dataclasses.replace(self.cfg, n_layers=n * unit + rem)

    @property
    def composes(self) -> bool:
        """The probes together trace fewer units than the real depth
        (below it, a full trace costs less)."""
        return self.units > sum(PROBE_UNITS)


def _model():
    # imported at use: ``models`` imports ``train``, whose steps carry
    # depth plans
    from ..models import model
    return model


def with_depth_plan(fn: Callable, cfg: ModelConfig,
                    make: Callable[[ModelConfig], Callable],
                    resize: Callable[[ModelConfig, list], list]) -> Callable:
    """``fn`` with its depth plan attached (``fn.depth_plan``). The
    attribute is not part of ``fn``'s content digest: the digest already
    covers ``cfg`` through ``fn``'s closure."""
    fn.depth_plan = DepthPlan(cfg, make, resize)
    return fn


def depth_plan(fn) -> DepthPlan | None:
    return getattr(fn, "depth_plan", None)


class _UnitLabels:
    """Each traced event's unit: ``pass * n + unit``, -1 outside the
    stack, ``_UNLABELLED`` for an event the engine records outside any
    node. ``mark`` is the model's ``UNIT_MARKS.fn`` in the probe's
    thread (the autograd engine runs a CPU graph's backward in the
    thread that asks for it)."""

    def __init__(self, n: int):
        self.n = n
        self.marks = 0
        self.current = -1
        self.seq_starts: list[int] = []
        self.seq_labels: list[int] = []

    def mark(self) -> None:
        p, k = divmod(self.marks, self.n + 1)
        label = p * self.n + k if k < self.n else -1
        # the sequence number the next autograd node will get
        self.seq_starts.append(torch._C._autograd._get_sequence_nr())
        self.seq_labels.append(label)
        self.current = label
        self.marks += 1

    def __call__(self) -> int:
        if torch._C._current_graph_task_id() == -1:
            return self.current
        node = torch._C._current_autograd_node()
        if node is None:
            return _UNLABELLED
        i = bisect.bisect_right(self.seq_starts, node._sequence_nr()) - 1
        return -1 if i < 0 else self.seq_labels[i]


# -- one probe ----------------------------------------------------------------
def _segments(labels: Sequence[int], n: int):
    """A probe's stream cut into ``(key, unit, start, end)`` segments:
    fixed ``("F", k)`` ones (maybe empty) around and between groups of
    unit runs ``("U", j)``, and the groups' ``(pass, step)``; None when
    the stream has another shape."""
    runs = []
    start = 0
    for i in range(1, len(labels) + 1):
        if i == len(labels) or labels[i] != labels[start]:
            runs.append((labels[start], start, i))
            start = i
    segs: list = []
    groups: list = []
    left, expect, n_fixed = 0, None, 0

    def fixed(s, e):
        nonlocal n_fixed
        segs.append((("F", n_fixed), None, s, e))
        n_fixed += 1

    for label, s, e in runs:
        if label == -1 and not left:
            fixed(s, e)
            continue
        if label < 0:
            return None
        p, u = divmod(label, n)
        if left:
            if (p, u) != expect:
                return None
        else:
            if not segs or segs[-1][0][0] != "F":
                fixed(s, s)
            if u not in (0, n - 1):
                return None
            groups.append((p, 1 if u == 0 else -1))
            left = n
        segs.append((("U", len(groups) - 1), u, s, e))
        left -= 1
        expect = (p, u + groups[-1][1])
    if left:
        return None
    if not segs or segs[-1][0][0] != "F":
        fixed(len(labels), len(labels))
    return segs, tuple(groups)


def _cls(u: int, n: int) -> str:
    return "first" if u == 0 else "last" if u == n - 1 else "mid"


@dataclasses.dataclass
class _Probe:
    """A probe trace taken apart: each segment instance's events as
    structure (what must match across probes) and values (sizes and
    shapes, which may move with the unit count)."""

    n: int
    entry: TracedPhase
    groups: tuple
    # (template key, unit) -> (structure, sizes, shapes) of its events
    instances: dict
    outputs: tuple       # each output block's (template key, offset)
    n_inputs: int

    @staticmethod
    def parse(n: int, entry: TracedPhase, labels) -> "_Probe | None":
        cut = _segments(labels, n)
        if cut is None:
            return None
        segs, groups = cut
        c = entry.trace.columnar()
        T = len(c)
        seg_of = np.empty(T, dtype=np.int64)
        for si, (_k, _u, s, e) in enumerate(segs):
            seg_of[s:e] = si
        kind = c.kind
        alloc_at = {}
        for i in np.flatnonzero(kind):
            alloc_at[int(c.block_id[i])] = int(i)
        ops, scopes, shapes = c.op_table, c.scope_table, c.shape_table

        def token(i: int) -> tuple:
            shape = shapes[c.shape[i]]
            return (1, ops[c.op[i]], scopes[c.scope[i]],
                    int(c.block_kind[i]), None if shape is None else len(shape))

        # each alloc's name within its unit run: its token and how many
        # allocs of that token came before it in the run
        name_of = {}
        for key, _u, s, e in segs:
            if key[0] == "U":
                seen: dict = {}
                for i in range(s, e):
                    if kind[i]:
                        tok = token(i)
                        name_of[i] = (tok, seen.get(tok, 0))
                        seen[tok] = seen.get(tok, 0) + 1

        def ref(si: int, ti: int):
            """How the free at segment ``si`` names the alloc at ``ti``."""
            key, u, _s, _e = segs[si]
            tkey, tu, ts, _te = segs[int(seg_of[ti])]
            if tkey[0] == "F":
                return ("F", tkey[1], ti - ts)
            if key[0] == "U":
                return ("U", tkey[1], tu - u, *name_of[ti])
            if tu in (0, n - 1):
                return ("U" + _cls(tu, n), tkey[1], *name_of[ti])
            return None

        instances: dict = {}
        for si, (key, u, s, e) in enumerate(segs):
            tkey = key if key[0] == "F" else (key[0], key[1], _cls(u, n))
            struct, sizes, shp = [], [], []
            for i in range(s, e):
                if kind[i]:
                    struct.append(token(i))
                    sizes.append(int(c.size[i]))
                    shp.append(shapes[c.shape[i]])
                    continue
                ti = alloc_at.get(int(c.block_id[i]))
                if ti is None or ti > i:
                    return None
                r = ref(si, ti)
                if r is None:
                    return None
                struct.append((0, ops[c.op[i]], r))
            instances[(tkey, u)] = (tuple(struct), sizes, shp)
        outputs = []
        for b in entry.output_blocks:
            i = alloc_at[b.bid]
            key, u, s, _e = segs[int(seg_of[i])]
            tkey = key if key[0] == "F" else (key[0], key[1], _cls(u, n))
            outputs.append((tkey, i - s))
        n_inputs = len(entry.input_blocks)
        if [b.bid for b in entry.input_blocks] != list(range(n_inputs)):
            return None
        return _Probe(n, entry, groups, instances, tuple(outputs), n_inputs)

    def templates(self) -> dict:
        """Template key -> its instances (a middle class has several)."""
        out: dict = {}
        for (tkey, _u), inst in self.instances.items():
            out.setdefault(tkey, []).append(inst)
        return out


def _affine(a, b, na: int, nb: int):
    """Integer ``(y0, y1)`` with ``y = y0 + y1 * n`` through two probes,
    or None."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    d = b - a
    if np.any(d % (nb - na)):
        return None
    y1 = d // (nb - na)
    return a - y1 * na, y1


class _DepthModel:
    """Templates and affine values fitted on two probes (see the module
    docstring); ``synthesize(N)`` builds the phase at ``N`` units."""

    def __init__(self, pa: _Probe, pb: _Probe):
        self.ok = False
        self.template_entry = pb.entry
        if pa.groups != pb.groups or pa.outputs != pb.outputs \
                or pa.n_inputs != pb.n_inputs \
                or pa.entry.arg_leaf_counts != pb.entry.arg_leaf_counts:
            return
        self.groups = pb.groups
        self.outputs = pb.outputs
        self.n_inputs = pb.n_inputs
        ta, tb = pa.templates(), pb.templates()
        fitted: dict = {}
        for tkey, insts in tb.items():
            struct, sizes, shapes = insts[0]
            if any(i[0] != struct or i[1] != sizes or i[2] != shapes
                   for i in insts[1:]):
                return
            if tkey[0] == "U" and tkey[2] == "mid":
                model = (np.asarray(sizes, dtype=np.int64),
                         np.zeros(len(sizes), dtype=np.int64))
                shape_models = [None if s is None else (s, (0,) * len(s))
                                for s in shapes]
                fitted[tkey] = (struct, model, shape_models)
                continue
            other = ta.get(tkey)
            if other is None or len(other) != 1 or other[0][0] != struct:
                return
            model = _affine(other[0][1], sizes, pa.n, pb.n)
            if model is None:
                return
            shape_models = []
            for sa, sb in zip(other[0][2], shapes):
                if sa is None:
                    shape_models.append(None)
                    continue
                m = _affine(sa, sb, pa.n, pb.n)
                if m is None:
                    return
                shape_models.append(tuple(tuple(int(x) for x in v)
                                          for v in m))
            fitted[tkey] = (struct, model, shape_models)
        if set(fitted) - {k for k in fitted if k[0] == "U"
                          and k[2] == "mid"} != set(ta):
            return
        self.fitted = fitted
        # each unit template's allocs by name (see ``_Probe.parse``)
        self.names = {}
        for tkey, (struct, _m, _s) in fitted.items():
            if tkey[0] == "U":
                seen: dict = {}
                names = self.names[tkey] = {}
                for o, r in enumerate(struct):
                    if r[0] == 1:
                        names[(r, seen.get(r, 0))] = o
                        seen[r] = seen.get(r, 0) + 1
        # the abstract outputs: the same tree, each leaf's dims affine
        la, sa = pytree.tree_flatten(pa.entry.out_shape)
        lb, sb = pytree.tree_flatten(pb.entry.out_shape)
        if str(sa) != str(sb) or len(la) != len(lb):
            return
        dims = []
        for x, y in zip(la, lb):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.dtype == y.dtype and x.ndim == y.ndim):
                return
            m = _affine(tuple(x.shape), tuple(y.shape), pa.n, pb.n)
            if m is None:
                return
            dims.append((m, y.dtype))
        self.out_spec, self.out_dims = sb, dims
        self.ok = True

    def synthesize(self, N: int) -> TracedPhase | None:
        """The phase at ``N`` units, or None when it cannot be built
        (a reference outside the stack, a double free, a negative
        size)."""
        if N < 2:
            return None
        fitted = self.fitted
        order = []            # (segment key, unit or None), in order
        n_groups = len(self.groups)
        for k in range(n_groups + 1):
            order.append((("F", k), None))
            if k == n_groups:
                break
            step = self.groups[k][1]
            units = range(N) if step == 1 else range(N - 1, -1, -1)
            order.extend((("U", k), u) for u in units)

        def tkey_of(key, u):
            return key if u is None else (key[0], key[1], _cls(u, N))

        # pass 1: where each instance starts
        starts = {}
        g = 0
        for key, u in order:
            starts[(key, u)] = g
            g += len(fitted[tkey_of(key, u)][0])
        T = g
        kind = np.zeros(T, dtype=np.uint8)
        bid = np.zeros(T, dtype=np.int64)
        size = np.zeros(T, dtype=np.int64)
        bkind = np.zeros(T, dtype=np.uint8)
        op: list = [None] * T
        scope: list = [None] * T
        shape: list = [None] * T
        freed = np.zeros(T, dtype=bool)
        next_bid = 0
        for key, u in order:
            struct, (s0, s1), shape_models = fitted[tkey_of(key, u)]
            sizes = s0 + s1 * N
            if (sizes < 0).any():
                return None
            g0 = starts[(key, u)]
            a = 0
            for o, r in enumerate(struct):
                i = g0 + o
                op[i] = r[1]
                if r[0] == 1:
                    kind[i] = 1
                    bid[i] = next_bid
                    next_bid += 1
                    size[i] = sizes[a]
                    scope[i] = r[2]
                    bkind[i] = r[3]
                    m = shape_models[a]
                    if m is not None:
                        dims = tuple(d0 + d1 * N for d0, d1 in zip(*m))
                        if any(d < 0 for d in dims):
                            return None
                        shape[i] = dims
                    a += 1
                    continue
                ref = r[2]
                if ref[0] == "F":
                    ti = starts[(("F", ref[1]), None)] + ref[2]
                else:
                    if ref[0] == "U":
                        if u is None:
                            return None
                        tu, name = u + ref[2], ref[3:]
                    else:
                        tu = 0 if ref[0] == "Ufirst" else N - 1
                        name = ref[2:]
                    if not 0 <= tu < N:
                        return None
                    tkey = ("U", ref[1], _cls(tu, N))
                    off = self.names[tkey].get(name)
                    if off is None:
                        return None
                    ti = starts[(("U", ref[1]), tu)] + off
                if not 0 <= ti < i or not kind[ti] or freed[ti]:
                    return None
                freed[ti] = True
                bid[i] = bid[ti]
                size[i] = size[ti]
                scope[i] = scope[ti]
                bkind[i] = bkind[ti]
                shape[i] = shape[ti]
        return self._assemble(N, kind, bid, size, bkind, op, scope, shape,
                              starts)

    def _assemble(self, N, kind, bid, size, bkind, op, scope, shape,
                  starts) -> TracedPhase:
        tp = self.template_entry
        tc = tp.trace.columnar()
        T = len(kind)
        ops, scopes, shapes = (StringInterner(), StringInterner(),
                               StringInterner([None]))
        columns = ColumnarTrace.from_columns(
            kind, bid, size, np.arange(T, dtype=np.int64),
            np.full(T, tc.iteration[0] if len(tc) else 0, dtype=np.int64),
            np.full(T, tc.phase[0] if len(tc) else 0, dtype=np.uint8),
            [ops.intern(x) for x in op], [scopes.intern(x) for x in scope],
            bkind, ops.table, scopes.table,
            [shapes.intern(x) for x in shape], shapes.table,
            np.zeros(T, dtype=np.uint8))
        meta = {k: v for k, v in tp.trace.meta.items()
                if k not in ("_columns", "depth")}
        trace = Trace.from_columnar(columns, num_iterations=1, meta=meta)
        # lifecycles, as the tracer keeps its blocks: in id order, the
        # kernel temporaries of one op all born at the first one's alloc
        free_t = {}
        for i in np.flatnonzero(kind == 0):
            free_t[int(bid[i])] = int(i)
        it = int(tc.iteration[0]) if len(tc) else 0
        phase = PHASE_TABLE[tc.phase[0]] if len(tc) else None
        temp = KIND_CODE[BlockKind.TEMP]
        lifecycles = []
        born = 0
        for i in np.flatnonzero(kind):
            i = int(i)
            if not (bkind[i] == temp and i and kind[i - 1]
                    and bkind[i - 1] == temp):
                born = i
            lifecycles.append(BlockLifecycle(
                int(bid[i]), int(size[i]), born, free_t.get(int(bid[i])),
                it, phase, op[i], scope[i], KIND_TABLE[bkind[i]], 1.0,
                shape[i]))
        lifecycles = tuple(lifecycles)
        inputs = tuple(BlockInfo(lc.block_id, lc.size, lc.block_kind,
                                 lc.shape)
                       for lc in lifecycles[:self.n_inputs])
        outs = []
        for (tkey, off), b in zip(self.outputs, tp.output_blocks):
            if tkey[0] == "F":
                i = starts[(tkey, None)] + off
            elif tkey[2] == "mid":
                return None
            else:
                i = starts[(tkey[:2], 0 if tkey[2] == "first"
                            else N - 1)] + off
            outs.append(BlockInfo(int(bid[i]), int(size[i]), b.kind,
                                  shape[i]))
        leaves = [torch.empty(tuple(int(d0 + d1 * N)
                                    for d0, d1 in zip(*m)),
                              dtype=dt, device="meta")
                  for m, dt in self.out_dims]
        return TracedPhase(
            trace=trace, lifecycles=lifecycles, input_blocks=inputs,
            output_blocks=tuple(outs),
            out_shape=pytree.tree_unflatten(leaves, self.out_spec),
            arg_leaf_counts=tp.arg_leaf_counts)


def phases_equal(a: TracedPhase, b: TracedPhase) -> bool:
    """Column-for-column equality of two phase traces: every trace
    column (ops, scopes and shapes by value and by table), the
    lifecycles, the input and output blocks and the abstract outputs."""
    ca, cb = a.trace.columnar(), b.trace.columnar()
    if len(ca) != len(cb):
        return False
    for f in ("kind", "block_id", "size", "t", "iteration", "phase", "op",
              "scope", "block_kind", "shape", "space"):
        if not np.array_equal(getattr(ca, f), getattr(cb, f)):
            return False
    if (ca.op_table != cb.op_table or ca.scope_table != cb.scope_table
            or ca.shape_table != cb.shape_table):
        return False
    if tuple(a.lifecycles) != tuple(b.lifecycles) \
            or a.input_blocks != b.input_blocks \
            or a.output_blocks != b.output_blocks \
            or a.arg_leaf_counts != b.arg_leaf_counts:
        return False
    la, sa = pytree.tree_flatten(a.out_shape)
    lb, sb = pytree.tree_flatten(b.out_shape)
    return str(sa) == str(sb) and len(la) == len(lb) and all(
        tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype
        for x, y in zip(la, lb))


def summary(info: dict) -> dict:
    """A trace's depth info as a decision reports it: ``source``, the
    real depth's ``units`` and the ``units_traced`` to make it."""
    return {k: info.get(k) for k in ("source", "units", "units_traced")}


def _sig(trees) -> tuple:
    leaves, spec = pytree.tree_flatten(list(trees))
    return (str(spec), tuple((tuple(t.shape), t.dtype) for t in leaves
                             if isinstance(t, torch.Tensor)))


def compose(plan: DepthPlan, args_with_kinds: Sequence[tuple],
            trace: Callable[..., TracedPhase]
            ) -> tuple[TracedPhase | None, dict]:
    """The phase of ``plan``'s step on ``args_with_kinds`` at the real
    depth, synthesized from probe traces, or None (then the caller
    traces it in full). ``trace(fn, args_with_kinds, labeller)`` traces
    one probe. Returns ``(phase or None, depth info)``: the info's
    ``source`` (``"composed"``/``"fallback"``), ``why`` a composition
    was refused, ``units``, ``probe_units``, the ``probes`` traced and
    their seconds (``probe_s``), and ``units_traced`` in all."""
    N = plan.units
    info: dict = {"source": "fallback", "units": N,
                  "probe_units": list(PROBE_UNITS), "probes": 0,
                  "probe_s": 0.0}
    # a refused composition is traced in full after its probes
    info["units_traced"] = N
    trees = [t for t, _k, _n in args_with_kinds]
    if not (hasattr(torch._C._autograd, "_get_sequence_nr")
            and hasattr(torch._C, "_current_autograd_node")):
        info["why"] = "no autograd sequence numbers in this torch"
        return None, info
    if _sig(plan.resize(plan.cfg, trees)) != _sig(trees):
        info["why"] = "inputs"
        return None, info
    t0 = time.perf_counter()
    probes = []
    for n in PROBE_UNITS:
        cfg = plan.at(n)
        labels = _UnitLabels(n)
        resized = plan.resize(cfg, trees)
        awk = [(t, k, name) for t, (_t, k, name)
               in zip(resized, args_with_kinds)]
        marks = _model().UNIT_MARKS
        prev = getattr(marks, "fn", None)
        marks.fn = labels.mark
        try:
            entry, tr = trace(plan.make(cfg), awk, labels)
        finally:
            marks.fn = prev
        info["probes"] += 1
        info["units_traced"] += n
        probe = _Probe.parse(n, entry, tr.labels)
        if probe is None:
            info["why"] = f"structure at {n} units"
            info["probe_s"] = time.perf_counter() - t0
            return None, info
        probes.append(probe)
    info["probe_s"] = time.perf_counter() - t0
    model = _DepthModel(probes[0], probes[1])
    if not model.ok:
        info["why"] = "fit"
        return None, info
    check = model.synthesize(probes[2].n)
    if check is None or not phases_equal(check, probes[2].entry):
        info["why"] = f"check at {probes[2].n} units"
        return None, info
    out = model.synthesize(N)
    if out is None:
        info["why"] = f"synthesis at {N} units"
        return None, info
    flat = [t for t in pytree.tree_leaves(trees)
            if isinstance(t, torch.Tensor)]
    if [(b.size, b.shape) for b in out.input_blocks] != \
            [(aval_bytes(t), tuple(t.shape)) for t in flat]:
        info["why"] = "inputs at the real depth"
        return None, info
    info["source"] = "composed"
    info["units_traced"] = sum(PROBE_UNITS)
    out.trace.meta["depth"] = dict(info)
    return out, info
