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
  template of its class (``_cls``): its distances from the group's
  first and last units, each capped at ``edge`` (1 here: the first
  unit, the last, or the middle ones; ``core/loops.py`` takes 2). A
  free names its block by where the alloc was: a fixed segment and the
  alloc's ordinal there, or a unit run and the alloc's name in the run:
  its op, scope, kind and rank, and how many such allocs came before it
  there (or after it). A name, not an offset, so a reference made to a
  middle unit resolves in an edge unit's run, which has allocs of its
  own (the last unit's backward makes the stacked gradients). From a
  unit run the unit is a step ``u' - u`` from the freeing unit or, for
  an edge unit, its class; the fit takes the first that both probes
  share. From a fixed segment it is a ``RUN`` of units affine in the
  group's count, one unit or a list of every unit's outputs dying at
  once.
* **The model.** Fitted on the first two probes: every fixed segment
  and edge run has the same events at both, and its sizes and shape
  dims are integer-affine in the unit count (the stacked ``[L, ...]``
  parameters, cache and gradients make them so); the middle runs are
  taken as they are, the same at every middle unit. Every other column
  follows: block ids number the allocs in order, ``t`` is the
  position, a free's size, scope, kind and shape are its block's. A
  synthesis may give each group a unit count of its own (a step loop's
  own step count, ``core/loops.py``).
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
        self.reset()

    def reset(self) -> None:
        """Back to before the first mark (another trace of the probe)."""
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


def _cls(u: int, n: int, edge: int = 1) -> tuple:
    """Unit ``u``'s template class in a group of ``n``: its distances
    from the group's first and last units, each capped at ``edge``;
    ``(edge, edge)`` is the middle class, the units of which repeat."""
    return min(u, edge), min(n - 1 - u, edge)


def _edge_unit(cls: tuple, n: int, edge: int) -> int:
    """The unit of an edge class ``cls`` in a group of ``n``."""
    return cls[0] if cls[0] < edge else n - 1 - cls[1]


def _collapse_runs(items: list) -> list:
    """A fixed segment's ``(item, label)`` pairs with consecutive frees
    that name one block in runs of consecutive units of one group (a
    list of the steps' outputs dying at once) as one ``RUN`` item."""
    out: list = []
    for it, lab in items:
        if it[0] == 0 and it[2][0][0] == "RUN" and out \
                and out[-1][0][0] == 0 and out[-1][0][2][0][0] == "RUN" \
                and out[-1][0][1] == it[1] and out[-1][1] == lab:
            _r, g, s, e = out[-1][0][2][0][:4]
            _r2, g2, s2 = it[2][0][:3]
            d = s2 - e
            names = {r[4:] for r in it[2]}
            keep = tuple(("RUN", g, s, s2, *r[4:]) for r in out[-1][0][2]
                         if r[4:] in names)
            if g2 == g and keep and abs(d) == 1 \
                    and (s == e or d == (1 if e > s else -1)):
                out[-1] = ((0, it[1], keep), lab)
                continue
        out.append((it, lab))
    return out


@dataclasses.dataclass
class _Probe:
    """A probe trace taken apart: each segment instance's items as
    structure (what must match across probes), values (sizes and shapes,
    which may move with the unit count) and labels (``extra``: other
    labellings of the events, one hashable value an event, carried
    through a synthesis).

    A free names its block by where the alloc was. In a unit run, by
    candidates that the fit chooses between: the alloc's unit as a step
    from the freeing unit, and, for a first or last unit's alloc, that
    class; in a fixed segment, by its fixed segment and item, or as a
    ``RUN`` of units of a group (``("RUN", group, from, to, name)``,
    the units affine in the group's count), which covers one unit's
    alloc and a list of every unit's outputs dying at once."""

    n: int
    edge: int
    entry: TracedPhase
    groups: tuple
    # (template key, unit) -> (structure, sizes, shapes, extra labels)
    instances: dict
    outputs: tuple       # each output block's (template key, item)
    n_inputs: int

    @staticmethod
    def parse(n: int, entry: TracedPhase, labels, extra=None,
              edge: int = 1) -> "_Probe | None":
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

        # each alloc's names within its unit run: its token and how many
        # allocs of that token come before it in the run, or (negative)
        # after it; each fixed alloc's ordinal in its segment
        name_of = {}
        item_of = {}
        for key, _u, s, e in segs:
            if key[0] == "U":
                seen: dict = {}
                for i in range(s, e):
                    if kind[i]:
                        tok = token(i)
                        name_of[i] = [tok, seen.get(tok, 0)]
                        seen[tok] = seen.get(tok, 0) + 1
                for i in range(s, e):
                    if kind[i]:
                        tok, k = name_of[i]
                        name_of[i] = ((tok, k), (tok, k - seen[tok]))
            else:
                a = 0
                for i in range(s, e):
                    if kind[i]:
                        item_of[i] = a
                        a += 1

        def cands(si: int, ti: int):
            """How the free at segment ``si`` may name the alloc at
            ``ti``."""
            key, u, _s, _e = segs[si]
            tkey, tu, ts, _te = segs[int(seg_of[ti])]
            if tkey[0] == "F":
                return (("F", tkey[1], item_of[ti]),)
            g, names = tkey[1], name_of[ti]
            if key[0] == "F":
                return tuple(("RUN", g, tu, tu, *nm) for nm in names)
            out = [("U", g, tu - u, *nm) for nm in names]
            if (tkey, tu) != (key, u):
                if tu < edge:
                    out.extend(("Uhead", g, tu, *nm) for nm in names)
                if n - 1 - tu < edge:
                    out.extend(("Utail", g, n - 1 - tu, *nm) for nm in names)
            return tuple(out)

        instances: dict = {}
        for si, (key, u, s, e) in enumerate(segs):
            tkey = key if key[0] == "F" else (key[0], key[1],
                                              _cls(u, n, edge))
            struct, sizes, shp, labs = [], [], [], []
            for i in range(s, e):
                if kind[i]:
                    struct.append(token(i))
                    sizes.append(int(c.size[i]))
                    shp.append(shapes[c.shape[i]])
                else:
                    ti = alloc_at.get(int(c.block_id[i]))
                    if ti is None or ti > i:
                        return None
                    struct.append((0, ops[c.op[i]], cands(si, ti)))
                labs.append(None if extra is None else extra[i])
            if key[0] == "F":
                merged = _collapse_runs(list(zip(struct, labs)))
                struct = [it for it, _l in merged]
                labs = [lab for _it, lab in merged]
            instances[(tkey, u)] = (tuple(struct), sizes, shp, tuple(labs))
        outputs = []
        for b in entry.output_blocks:
            i = alloc_at[b.bid]
            key, u, s, _e = segs[int(seg_of[i])]
            if key[0] == "F":
                outputs.append((key, item_of[i]))
            else:
                outputs.append(((key[0], key[1], _cls(u, n, edge)), i - s))
        n_inputs = len(entry.input_blocks)
        if [b.bid for b in entry.input_blocks] != list(range(n_inputs)):
            return None
        return _Probe(n, edge, entry, groups, instances, tuple(outputs),
                      n_inputs)

    def templates(self) -> dict:
        """Template key -> its instances (a middle class has several)."""
        out: dict = {}
        for (tkey, _u), inst in self.instances.items():
            out.setdefault(tkey, []).append(inst)
        return out


def _affine(a, b, na: int, nb: int):
    """Integer ``(y0, y1)`` with ``y = y0 + y1 * n`` through two probes
    (through one, ``na == nb``: the constant), or None."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    if na == nb:
        return (b, np.zeros_like(b)) if np.array_equal(a, b) else None
    d = b - a
    if np.any(d % (nb - na)):
        return None
    y1 = d // (nb - na)
    return a - y1 * na, y1


def _anchor(u: int, n: int, edge: int):
    """Unit ``u`` of a group of ``n`` as ``(y0, y1)``, ``u = y0 + y1 *
    n``: counted from the group's start or end, whichever it is within
    ``edge`` of; None for a middle unit."""
    if u < edge:
        return u, 0
    if u >= n - edge:
        return u - n, 1
    return None


def _fit_struct(sa, sb, na: int, nb: int, edge: int = 1):
    """One template's structure fitted on two probes (``na`` and ``nb``
    units; ``na == nb`` for the instances of a middle class, or for a
    fit on one probe): allocs equal, each free's name the first
    candidate every instance shares, a ``RUN``'s units affine in the
    count (from one probe: anchored to the group's nearer end); None
    when they differ."""
    if len(sa) != len(sb):
        return None
    out = []
    for x, y in zip(sa, sb):
        if x[0] == 1 or y[0] == 1:
            if x != y:
                return None
            out.append(x)
            continue
        if x[1] != y[1]:
            return None
        if (x[2][0][0] == "RUN") != (y[2][0][0] == "RUN"):
            return None
        if x[2][0][0] == "RUN":
            rx, ry = x[2][0], y[2][0]
            if rx[1] != ry[1]:
                return None
            if na == nb:
                if rx[2:4] != ry[2:4]:
                    return None
                ends = tuple(_anchor(u, na, edge) for u in rx[2:4])
                if None in ends:
                    return None
            else:
                fit = _affine(rx[2:4], ry[2:4], na, nb)
                if fit is None:
                    return None
                (s0, e0), (s1, e1) = fit
                ends = ((int(s0), int(s1)), (int(e0), int(e1)))
            names = {r[4:] for r in y[2]}
            both = tuple(("RUN", rx[1], *ends, *r[4:]) for r in x[2]
                         if r[4:] in names)
        else:
            both = tuple(r for r in x[2] if r in y[2])
        if not both:
            return None
        out.append((0, x[1], both))
    return tuple(out)


def _chosen(struct, edge_first: bool = False):
    """A fitted structure with each free's first shared candidate, or
    (``edge_first``) its first that names an edge unit's class: from one
    probe, a step between two edge units can be the count's."""
    def pick(refs):
        if edge_first:
            for r in refs:
                if r[0] in ("Uhead", "Utail"):
                    return r
        return refs[0]
    return tuple(it if it[0] == 1 else (0, it[1], pick(it[2]))
                 for it in struct)


class _DepthModel:
    """Templates and affine values fitted on two probes (see the module
    docstring); ``synthesize(N)`` builds the phase at ``N`` units."""

    def __init__(self, pa: _Probe, pb: _Probe | None = None):
        # one probe (``pb`` None): every size and shape taken as constant
        # in the count, which the check on another probe must confirm
        single = pb is None
        if single:
            pb = pa
        self.ok = False
        self.template_entry = pb.entry
        self.edge = edge = pb.edge
        mid = (edge, edge)
        if pa.edge != edge or pa.groups != pb.groups \
                or pa.outputs != pb.outputs \
                or pa.n_inputs != pb.n_inputs \
                or pa.entry.arg_leaf_counts != pb.entry.arg_leaf_counts:
            return
        self.groups = pb.groups
        self.outputs = pb.outputs
        self.n_inputs = pb.n_inputs
        ta, tb = pa.templates(), pb.templates()
        fitted: dict = {}
        for tkey, insts in tb.items():
            struct, sizes, shapes, labs = insts[0]
            if any(i[1] != sizes or i[2] != shapes or i[3] != labs
                   for i in insts[1:]):
                return
            if tkey[0] == "U" and tkey[2] == mid:
                for i in insts[1:]:
                    struct = _fit_struct(struct, i[0], pb.n, pb.n, edge)
                    if struct is None:
                        return
                model = (np.asarray(sizes, dtype=np.int64),
                         np.zeros(len(sizes), dtype=np.int64))
                shape_models = [None if s is None else (s, (0,) * len(s))
                                for s in shapes]
                fitted[tkey] = (_chosen(struct), model, shape_models, labs)
                continue
            other = ta.get(tkey)
            if other is None or len(other) != 1 or other[0][3] != labs:
                return
            fs = _fit_struct(other[0][0], struct, pa.n, pb.n, edge)
            if fs is None:
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
            fitted[tkey] = (_chosen(fs, single), model, shape_models,
                            labs)
        def edges(keys):
            return {k for k in keys if not (k[0] == "U" and k[2] == mid)}
        if edges(fitted) != edges(ta):
            return
        self.fitted = fitted
        # each unit template's allocs by name (see ``_Probe.parse``)
        self.names = {}
        for tkey, (struct, _m, _s, _l) in fitted.items():
            if tkey[0] == "U":
                seen: dict = {}
                names = self.names[tkey] = {}
                for o, r in enumerate(struct):
                    if r[0] == 1:
                        names[(r, seen.get(r, 0))] = o
                        seen[r] = seen.get(r, 0) + 1
                for (r, k), o in list(names.items()):
                    names[(r, k - seen[r])] = o
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

    def synthesize(self, N: int, units: Sequence[int] | None = None):
        """The phase at ``N`` units and its extra labels, or None when
        it cannot be built (a reference outside the stack, a double
        free, a negative size). ``units`` gives each group's own unit
        count (default ``N`` for all); sizes and shapes are taken at
        ``N``. Each instance's columns are its template's, laid down by
        slices; a free's block is resolved in Python, the checks and
        the blocks' columns are vector operations."""
        n_groups = len(self.groups)
        units = [N] * n_groups if units is None else list(units)
        if len(units) != n_groups or any(n < 2 * self.edge for n in units):
            return None
        edge = self.edge
        order = []            # (segment key, unit or None, group count)
        for k in range(n_groups + 1):
            order.append((("F", k), None, 0))
            if k == n_groups:
                break
            step, n = self.groups[k][1], units[k]
            us = range(n) if step == 1 else range(n - 1, -1, -1)
            order.extend((("U", k), u, n) for u in us)

        def run_units(r):
            n = units[r[1]]
            a, b = r[2][0] + r[2][1] * n, r[3][0] + r[3][1] * n
            return range(a, b + 1) if b >= a else range(a, b - 1, -1)

        # each template at N: its items laid out as events (a fixed
        # segment's RUN items expanded), with op, scope, kind, size and
        # shape ids, interned in the order the events first show them
        ops, scopes, shapes = (StringInterner(), StringInterner(),
                               StringInterner([None]))
        tpls: dict = {}

        def template(tkey):
            got = tpls.get(tkey)
            if got is not None:
                return got
            struct, (s0, s1), shape_models, labs = self.fitted[tkey]
            sizes = s0 + s1 * N
            if (sizes < 0).any():
                return None
            kind, op, scope, bkind, size, shape, lab, frees = \
                [], [], [], [], [], [], [], []
            a = 0
            for r, lb in zip(struct, labs):
                if r[0] == 1:
                    m = shape_models[a]
                    dims = None if m is None else tuple(
                        d0 + d1 * N for d0, d1 in zip(*m))
                    if dims is not None and any(d < 0 for d in dims):
                        return None
                    kind.append(1)
                    op.append(ops.intern(r[1]))
                    scope.append(scopes.intern(r[2]))
                    bkind.append(r[3])
                    size.append(int(sizes[a]))
                    shape.append(shapes.intern(dims))
                    lab.append(lb)
                    a += 1
                    continue
                count = len(run_units(r[2])) if r[2][0] == "RUN" else 1
                frees.append((len(kind), r[2]))
                o = ops.intern(r[1])
                kind += [0] * count
                op += [o] * count
                scope += [0] * count
                bkind += [0] * count
                size += [0] * count
                shape += [0] * count
                lab += [lb] * count
            got = tpls[tkey] = (np.asarray(kind, dtype=np.uint8),
                                np.asarray(op, dtype=np.int32),
                                np.asarray(scope, dtype=np.int32),
                                np.asarray(bkind, dtype=np.uint8),
                                np.asarray(size, dtype=np.int64),
                                np.asarray(shape, dtype=np.int32), lab,
                                frees)
            return got

        # pass 1: each instance's template and start; each fixed alloc's
        # event by its ordinal
        starts = {}
        placed = []
        fixed_pos = {}
        g = 0
        for key, u, n in order:
            tkey = key if u is None else (key[0], key[1], _cls(u, n, edge))
            tp = template(tkey)
            if tp is None:
                return None
            starts[(key, u)] = g
            placed.append((key, u, tp, g))
            if u is None:
                fixed_pos[key[1]] = g + np.flatnonzero(tp[0])
            g += len(tp[0])
        T = g
        kind = np.zeros(T, dtype=np.uint8)
        op = np.zeros(T, dtype=np.int32)
        scope = np.zeros(T, dtype=np.int32)
        bkind = np.zeros(T, dtype=np.uint8)
        size = np.zeros(T, dtype=np.int64)
        shape = np.zeros(T, dtype=np.int32)
        target = np.full(T, -1, dtype=np.int64)
        labels: list = [None] * T

        def unit_alloc(gk, tu, name):
            n = units[gk]
            if not 0 <= tu < n:
                return -1
            off = self.names.get(("U", gk, _cls(tu, n, edge)), {}).get(
                tuple(name))
            return -1 if off is None else starts[(("U", gk), tu)] + off

        for key, u, tp, s in placed:
            e = s + len(tp[0])
            kind[s:e], op[s:e], scope[s:e], bkind[s:e], size[s:e], \
                shape[s:e] = tp[:6]
            labels[s:e] = tp[6]
            for i, ref in tp[7]:
                i += s
                if ref[0] == "RUN":
                    ts = [unit_alloc(ref[1], tu, ref[4:])
                          for tu in run_units(ref)]
                    target[i:i + len(ts)] = ts
                    continue
                if ref[0] == "F":
                    pos = fixed_pos.get(ref[1])
                    ti = -1 if pos is None or ref[2] >= len(pos) \
                        else pos[ref[2]]
                elif ref[0] == "U":
                    if u is None:
                        return None
                    ti = unit_alloc(ref[1], u + ref[2], ref[3:])
                else:
                    tu = ref[2] if ref[0] == "Uhead" \
                        else units[ref[1]] - 1 - ref[2]
                    ti = unit_alloc(ref[1], tu, ref[3:])
                target[i] = ti
        free = np.flatnonzero(kind == 0)
        t = target[free]
        if (t < 0).any() or (t >= free).any() or not kind[t].all() \
                or len(np.unique(t)) != len(t):
            return None
        alloc = np.flatnonzero(kind)
        bid = np.zeros(T, dtype=np.int64)
        bid[alloc] = np.arange(len(alloc), dtype=np.int64)
        bid[free] = bid[t]
        for col in (scope, bkind, size, shape):
            col[free] = col[t]
        out = self._assemble(N, units, kind, bid, size, bkind, op, scope,
                             shape, (ops.table, scopes.table, shapes.table),
                             starts, fixed_pos)
        return None if out is None else (out, labels)

    def _assemble(self, N, units, kind, bid, size, bkind, op, scope, shape,
                  tables, starts, fixed_pos) -> TracedPhase | None:
        tp = self.template_entry
        tc = tp.trace.columnar()
        T = len(kind)
        op_table, scope_table, shape_table = tables
        columns = ColumnarTrace.from_columns(
            kind, bid, size, np.arange(T, dtype=np.int64),
            np.full(T, tc.iteration[0] if len(tc) else 0, dtype=np.int64),
            np.full(T, tc.phase[0] if len(tc) else 0, dtype=np.uint8),
            op, scope, bkind, op_table, scope_table, shape, shape_table,
            np.zeros(T, dtype=np.uint8))
        meta = {k: v for k, v in tp.trace.meta.items()
                if k not in ("_columns", "depth", "loops")}
        trace = Trace.from_columnar(columns, num_iterations=1, meta=meta)
        # lifecycles, as the tracer keeps its blocks: in id order, the
        # kernel temporaries of one op all born at the first one's alloc
        alloc = np.flatnonzero(kind)
        free = np.flatnonzero(kind == 0)
        free_t = np.full(len(alloc), -1, dtype=np.int64)
        free_t[bid[free]] = free
        is_temp = bkind == KIND_CODE[BlockKind.TEMP]
        follows = np.zeros(T, dtype=bool)
        follows[1:] = is_temp[1:] & (kind[:-1] == 1) & is_temp[:-1]
        born = np.maximum.accumulate(np.where(follows[alloc], 0, alloc))
        it = int(tc.iteration[0]) if len(tc) else 0
        phase = PHASE_TABLE[tc.phase[0]] if len(tc) else None
        lifecycles = tuple(
            BlockLifecycle(b, sz, br, None if ft < 0 else ft, it, phase,
                           op_table[o], scope_table[sc], KIND_TABLE[bk],
                           1.0, shape_table[sh])
            for b, sz, br, ft, o, sc, bk, sh in zip(
                range(len(alloc)), size[alloc].tolist(), born.tolist(),
                free_t.tolist(), op[alloc].tolist(), scope[alloc].tolist(),
                bkind[alloc].tolist(), shape[alloc].tolist()))
        inputs = tuple(BlockInfo(lc.block_id, lc.size, lc.block_kind,
                                 lc.shape)
                       for lc in lifecycles[:self.n_inputs])
        outs = []
        for (tkey, off), b in zip(self.outputs, tp.output_blocks):
            if tkey[0] == "F":
                i = fixed_pos[tkey[1]][off]
            elif tkey[2] == (self.edge, self.edge):
                return None
            else:
                i = starts[(tkey[:2], _edge_unit(tkey[2], units[tkey[1]],
                                                 self.edge))] + off
            outs.append(BlockInfo(int(bid[i]), int(size[i]), b.kind,
                                  shape_table[shape[i]]))
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
    real depth's ``units`` and the ``units_traced`` to make it, and,
    for a step with long loops, their composition (``loops``: its
    ``source``, the ``steps`` and the ``steps_traced``, ``why`` one fell
    back, and the ``levels`` when loops nest)."""
    out = {k: info.get(k) for k in ("source", "units", "units_traced")}
    loops = info.get("loops")
    if loops:
        out["loops"] = {k: loops[k] for k in ("source", "why", "steps",
                                              "steps_traced") if k in loops}
        levels = len(loops.get("by_level", ()))
        if levels > 1:
            out["loops"]["levels"] = levels
    return out


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
    if check is None or not phases_equal(check[0], probes[2].entry):
        info["why"] = f"check at {probes[2].n} units"
        return None, info
    out = model.synthesize(N)
    if out is None:
        info["why"] = f"synthesis at {N} units"
        return None, info
    out = out[0]
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
