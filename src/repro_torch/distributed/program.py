"""Rank 0's local program of a sharded step (the port's counterpart of
lowering a step over sharded ``ShapeDtypeStruct``s).

A sharded step takes DTensor trees (parameters, optimizer state, batch,
KV cache) laid out by the rule engine (``sharding.py``) and runs under
a bound logical-axis scope (``act_sharding.logical_axis_rules``).
:class:`Program` wraps such a step so that it takes and returns the
*local* shards: each argument leaf is rebuilt as a DTensor from its
local tensor with the layout recorded for it (placements, global shape
and stride), the step runs, and each output DTensor is laid out as
asked (a partial reduced, the optimizer state moved to its own layout)
and handed back as its local tensor. The estimator traces that local
function on local ``meta`` stand-ins, so the trace is this rank's
program, its collectives included, through the ordinary phase path;
on the card the same step runs on real local shards.

Shard placement is the rule engine's: every rule keeps only axes that
divide their dim, so a local shard is its global shape with each
sharded dim divided by its mesh axes (:func:`local_shape`).

The process group comes from the caller. ``launch/mesh.py:fake_world``
gives rank 0 of a ``fake`` group of the mesh's size: its collectives
return outputs of the right shape and move no data, so one process can
run or trace rank 0 of a 256-rank mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from ..core.depth import depth_plan, with_depth_plan
from . import act_sharding as act
from .sharding import (Placements, ShardingPolicy, batch_shardings,
                       cache_shardings, opt_state_shardings, param_shardings)


@dataclasses.dataclass(frozen=True)
class Layout:
    """One leaf's DTensor layout: placements, global shape and stride."""
    placements: tuple
    shape: tuple
    stride: tuple


def _is_layout(x) -> bool:
    return isinstance(x, (Layout, Placements))


def local_shape(shape, placements, mesh) -> tuple:
    """The local shard's shape of a tensor of global ``shape``."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over mesh dim {i} ({n})")
            out[p.dim] //= n
    return tuple(out)


def layouts(tree, placements_tree) -> object:
    """The :class:`Layout` of each leaf of ``tree`` (global tensors of
    any device) under ``placements_tree`` (a ``*_shardings`` result)."""
    return pytree.tree_map(
        lambda t, pl: Layout(tuple(pl), tuple(t.shape),
                             act._contiguous_stride(t.shape)),
        tree, placements_tree, is_leaf=_is_layout)


def local_meta(layout_tree, dtype_tree, mesh):
    """``meta`` stand-ins of each leaf's local shard."""
    return pytree.tree_map(
        lambda lay, t: torch.empty(local_shape(lay.shape, lay.placements,
                                               mesh),
                                   dtype=t.dtype, device="meta"),
        layout_tree, dtype_tree, is_leaf=_is_layout)


def to_dtensor(local, lay: Layout, mesh):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, list(lay.placements),
                              run_check=False, shape=lay.shape,
                              stride=lay.stride)


def shard(tree, layout_tree, mesh):
    """``tree`` of local shards as DTensors with their layouts."""
    return pytree.tree_map(lambda lay, t: to_dtensor(t, lay, mesh),
                           layout_tree, tree, is_leaf=_is_layout)


def materialize(layout_tree, dtype_tree, mesh, device, seed: int = 0):
    """Real local shards on ``device``: floating leaves drawn N(0,
    0.02²) from a generator seeded with ``seed``, integer leaves zeros;
    as DTensors with their layouts."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(lay, t):
        shape = local_shape(lay.shape, lay.placements, mesh)
        if t.dtype.is_floating_point:
            x = torch.randn(shape, generator=gen, dtype=t.dtype,
                            device=device).mul_(0.02)
        else:
            x = torch.zeros(shape, dtype=t.dtype, device=device)
        return to_dtensor(x, lay, mesh)
    return pytree.tree_map(make, layout_tree, dtype_tree, is_leaf=_is_layout)


def _whole(x, lay: Layout | None):
    """An output DTensor laid out as ``lay`` (default: its own
    placements with every partial reduced), as its local tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return x
    pl = list(lay.placements) if lay is not None else [
        Replicate() if isinstance(p, Partial) else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x.to_local()


@dataclasses.dataclass
class Program:
    """A step over DTensor arguments as rank 0's local function.

    ``step(*trees)`` is the sharded step; ``arg_layouts`` one layout
    tree per argument; ``out_layouts`` (optional) a function of the
    step's output giving its layout tree (None leaves keep their own
    placements, partials reduced)."""
    step: Callable
    mesh: object
    rules: dict
    arg_layouts: tuple
    out_layouts: Callable | None = None

    def __post_init__(self):
        #: the local function, with a depth plan where the job gives one
        self.local = self.local_fn()

    def run(self, *trees):
        """The sharded step on DTensor trees, in the logical-axis scope."""
        with act.logical_axis_rules(self.mesh, self.rules):
            return self.step(*trees)

    def local_fn(self) -> Callable:
        """``(*local trees) -> local outputs``: the function the
        estimator traces (and that a rank would run)."""
        mesh, lays, run, outs = (self.mesh, self.arg_layouts, self.run,
                                 self.out_layouts)

        def local_step(*trees):
            out = run(*(shard(t, lay, mesh) for t, lay in zip(trees, lays)))
            want = outs(out) if outs is not None else None
            if want is None:
                return pytree.tree_map(lambda x: _whole(x, None), out)
            return pytree.tree_map(
                lambda lay, x: _whole(x, lay), want, out,
                is_leaf=lambda x: x is None or _is_layout(x))
        return local_step


# ---------------------------------------------------------------------------
# the dense family's steps as programs on a mesh
@dataclasses.dataclass
class ShardedJob:
    """A model step on a mesh: its programs (training: fwd_bwd, update,
    opt_init; serving: the step), the global abstract trees and their
    layouts, and the local ``meta`` trees the estimator traces."""
    mesh: object
    policy: ShardingPolicy
    kind: str                       # "train", "prefill" or "decode"
    programs: dict                  # name -> Program
    trees: dict                     # name -> global abstract tree
    layouts: dict                   # name -> layout tree
    local: dict                     # name -> local meta tree


def sharded_job(cfg: ModelConfig, shape, mesh, policy: ShardingPolicy,
                kind: str, *, train_policy=None, rules=None,
                cache_len: int | None = None) -> ShardedJob:
    """``cfg``'s ``kind`` step at ``shape`` (a ``ShapeSpec``) on ``mesh``
    under ``policy``: the reference's ``run_cell`` layouts (params by
    ``param_shardings``, optimizer state by ``opt_state_shardings``, the
    batch by ``batch_shardings``, the cache by ``cache_shardings``)."""
    from ..configs.registry import (abstract_cache, decode_input_specs,
                                    input_specs)
    from ..models import model as M
    from ..train import train_step as ts
    rules = act.DEFAULT_RULES if rules is None else rules
    params = M.abstract_params(cfg)
    trees = {"params": params}
    lays = {"params": layouts(params, param_shardings(params, cfg, mesh,
                                                      policy))}
    programs = {}
    if kind == "train":
        tp = train_policy or ts.TrainPolicy()
        fwd, update, init = ts.make_estimator_hooks(cfg, tp)
        batch = input_specs(cfg, shape)
        opt = init(params)          # zeros on ``meta``: no allocation
        trees.update(batch=batch, opt_state=opt)
        lays["batch"] = layouts(batch, batch_shardings(batch, mesh, policy))
        lays["opt_state"] = layouts(opt, opt_state_shardings(opt, mesh,
                                                             policy))
        grads_lay = lays["params"]
        programs["fwd_bwd"] = _with_plan(Program(
            fwd, mesh, rules, (lays["params"], lays["batch"]),
            lambda out: (None, grads_lay)), fwd, "fwd_bwd", cfg, shape,
            mesh, policy, kind, tp, rules)
        programs["update"] = Program(
            update, mesh, rules, (lays["params"], grads_lay,
                                  lays["opt_state"]),
            lambda out: None)
        opt_lay = lays["opt_state"]
        programs["opt_init"] = Program(init, mesh, rules, (lays["params"],),
                                       lambda out: opt_lay)
    elif kind == "prefill":
        # a serving step's (params, cache, batch), with no cache: the
        # prefill fills none (as the reference's)
        batch = input_specs(cfg, shape)
        trees.update(cache={}, batch=batch)
        lays.update(cache={}, batch=layouts(batch, batch_shardings(
            batch, mesh, policy)))
        step = _prefill_step(cfg)
        programs["step"] = _with_plan(Program(
            step, mesh, rules, (lays["params"], {}, lays["batch"])), step,
            "step", cfg, shape, mesh, policy, kind, None, rules)
    elif kind == "decode":
        cl = shape.seq_len - 1 if cache_len is None else cache_len
        cache = abstract_cache(cfg, shape)
        batch = decode_input_specs(cfg, shape)
        trees.update(cache=cache, batch=batch)
        lays["cache"] = layouts(cache, cache_shardings(cache, mesh, policy))
        lays["batch"] = layouts(batch, batch_shardings(batch, mesh, policy))
        step = ts.make_serve_step(cfg, cl)
        cache_lay = lays["cache"]
        programs["step"] = _with_plan(Program(
            step, mesh, rules, (lays["params"], cache_lay, lays["batch"]),
            lambda out: (None, cache_lay)), step, "step", cfg, shape, mesh,
            policy, kind, None, rules, cl)
    else:
        raise ValueError(f"unknown step kind {kind!r}")
    local = {name: local_meta(lays[name], trees[name], mesh)
             for name in trees}
    return ShardedJob(mesh, policy, kind, programs, trees, lays, local)


def _prefill_step(cfg: ModelConfig):
    """``make_prefill_step(cfg)`` as a serving step ``(params, cache,
    batch)`` that takes no cache."""
    from ..train.train_step import make_prefill_step, serving_args_at
    step = make_prefill_step(cfg)

    def prefill(params, cache, batch):
        return step(params, batch)
    return with_depth_plan(prefill, cfg, _prefill_step, serving_args_at)


def _with_plan(program: Program, step, name: str, cfg, shape, mesh, policy,
               kind, tp, rules, cache_len=None) -> Program:
    """Give the program's local function the depth plan of ``step``: at
    another depth the job is rebuilt (its layouts anew) and its local
    trees are the arguments."""
    if depth_plan(step) is None:
        return program
    fn = program.local

    def make(c):
        return sharded_job(c, shape, mesh, policy, kind, train_policy=tp,
                           rules=rules,
                           cache_len=cache_len).programs[name].local

    def resize(c, trees):
        job = sharded_job(c, shape, mesh, policy, kind, train_policy=tp,
                          rules=rules, cache_len=cache_len)
        names = {"train": ("params", "batch"),
                 "prefill": ("params", "cache", "batch"),
                 "decode": ("params", "cache", "batch")}[kind]
        return [job.local[n] for n in names]
    program.local = with_depth_plan(fn, cfg, make, resize)
    return program
