"""Training and serving step factories (PyTorch port of
``repro.train.train_step``).

``make_train_step`` builds the eager step: loss and gradients
(``torch.autograd.grad``, remat inside the model) -> optional microbatch
accumulation into f32 buffers -> optional global-norm clipping -> the
in-place optimizer update. The xMem estimator consumes the same pieces
(``make_estimator_hooks``: fwd_bwd / update / opt_init), so it is wired
to the real step, not to a model of it.

Serving steps run under ``torch.no_grad()``.

Every step the estimator traces (``make_fwd_bwd``, ``make_prefill_step``,
``make_serve_step``) carries a ``core.depth.DepthPlan``: how to build it
and its inputs at another depth, so a deep stack's trace is composed
from a few units. The steps are plain closures over their config, so
their trace keys are content digests (``core.cache.fn_identity``): equal
configs give equal keys in every process.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from ..core.depth import with_depth_plan
from ..distributed.act_sharding import from_local, is_dtensor
from ..models import model as M
from .optimizer import (Optimizer, _zeros32, clip_by_global_norm,
                        get_optimizer)


def params_at(cfg: ModelConfig, trees: list) -> list:
    """A step's ``(params, ...)`` arguments at ``cfg``'s depth."""
    return [M.abstract_params(cfg), *trees[1:]]


def serving_args_at(cfg: ModelConfig, trees: list) -> list:
    """A serving step's ``(params, cache, batch)`` at ``cfg``'s depth."""
    params, cache, batch = trees
    return [M.abstract_params(cfg), M.abstract_cache_like(cfg, cache), batch]


@dataclasses.dataclass(frozen=True)
class TrainPolicy:
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    clip_norm: float | None = 1.0
    microbatches: int = 1          # gradient-accumulation steps
    opt_kwargs: tuple = ()


def make_fwd_bwd(cfg: ModelConfig, microbatches: int = 1) -> Callable:
    """(params, batch) -> (loss, grads), optionally accumulating over
    ``microbatches`` as the JAX package's scan does: f32 accumulators
    made before the first microbatch, each microbatch's gradients added
    in and freed, the sum divided by ``n`` (so accumulated gradients are
    f32). ``batch`` leading dims must divide evenly.

    ``params`` are plain tensors; the step detaches them and asks for
    their gradients, so the caller's parameters never carry autograd
    state between steps."""
    def fwd_bwd(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        loss = M.loss_fn(pytree.tree_unflatten(leaves, spec), batch, cfg)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
        # stacked [L, ...] leaves get their gradient through
        # ``model._LayerSlice``, which writes it into the leaf's .grad
        grads = [g if g is not None else
                 p.grad if p.grad is not None else torch.zeros_like(p)
                 for g, p in zip(got, leaves)]
        if is_dtensor(loss):
            # a sharded step reduces each gradient to its parameter's
            # layout (the reduce-scatter or all-reduce of FSDP and DDP)
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        return loss.detach(), pytree.tree_unflatten(grads, spec)

    def at(c):
        return make_fwd_bwd(c, microbatches)
    if microbatches <= 1:
        return with_depth_plan(fwd_bwd, cfg, at, params_at)
    n = microbatches

    def fwd_bwd_accum(params, batch):
        acc = pytree.tree_map(_zeros32, params)
        acc_leaves = pytree.tree_leaves(acc)
        loss_sum = None
        for micro in _split_microbatches(batch, n):
            loss, grads = fwd_bwd(params, micro)
            for a, g in zip(acc_leaves, pytree.tree_leaves(grads)):
                a.add_(g)
            del grads
            loss_sum = loss if loss_sum is None else loss_sum + loss
        for a in acc_leaves:
            a.div_(n)
        return loss_sum / n, acc

    return with_depth_plan(fwd_bwd_accum, cfg, at, params_at)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of ``batch``, as views along the batch dim.

    A DTensor batch sharded over its rows is split on each rank's own
    rows: microbatch ``k`` is the ``k``-th slice of every rank's shard,
    sharded as the batch is. (Split globally, a microbatch would be
    replicated unless ``n`` divided the mesh, and every rank would run
    all of it.)"""
    for x in pytree.tree_leaves(batch):
        local = x.to_local() if is_dtensor(x) else x
        if local.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by {n} "
                             f"microbatches")

    def split(x, k):
        if is_dtensor(x):
            local = x.to_local()
            part = local.reshape((n, local.shape[0] // n)
                                 + local.shape[1:])[k]
            return from_local(part, x.device_mesh, x.placements,
                              (x.shape[0] // n,) + tuple(x.shape[1:]))
        return x.reshape((n, x.shape[0] // n) + x.shape[1:])[k]
    return [pytree.tree_map(lambda x: split(x, k), batch) for k in range(n)]


def _optimizer_and_update(policy: TrainPolicy) -> tuple[Optimizer, Callable]:
    opt = get_optimizer(policy.optimizer, lr=policy.learning_rate,
                        **dict(policy.opt_kwargs))
    update_fn = opt.update
    if policy.clip_norm is not None:
        update_fn = clip_by_global_norm(update_fn, policy.clip_norm)
    return opt, update_fn


def make_train_step(cfg: ModelConfig, policy: TrainPolicy
                    ) -> tuple[Callable, Optimizer]:
    """Returns (train_step(params, opt_state, batch) -> loss, optimizer).
    The step updates ``params`` and ``opt_state`` in place; its
    gradients die when it returns."""
    opt, update_fn = _optimizer_and_update(policy)
    fwd_bwd = make_fwd_bwd(cfg, policy.microbatches)

    def train_step(params, opt_state, batch):
        loss, grads = fwd_bwd(params, batch)
        update_fn(params, grads, opt_state)
        return loss

    return train_step, opt


@dataclasses.dataclass
class TrainRun:
    losses: list[float]           # each step's loss, in this run
    step_s: list[float]           # each step's wall time (synchronized)
    step: int = 0                 # the next step to run
    opt_state: Any = None         # made at the first update, or restored
    torn: bool = False            # an in-place update was cut short


def run_steps(fwd_bwd: Callable, update_fn: Callable, opt_init_fn: Callable,
              params, batch_fn: Callable, steps: int,
              run: TrainRun | None = None,
              on_step: Callable | None = None) -> TrainRun:
    """The training loop: from ``run.step`` (default: a fresh run from
    step 0) up to ``steps``, ``batch_fn(step)`` (tensors on
    ``device``), forward+backward, in-place update, then
    ``on_step(run)``. Unless ``run`` brings one, the optimizer state is
    made after the first backward, where the estimator's composition
    places it. Each step ends with its loss on the host, so its wall
    time covers the device's work; the gradients and the batch die with
    the step.

    ``run`` is updated as the loop goes, so a caller that catches an
    exception holds the last state: ``run.torn`` is set while the update
    writes ``params`` and the state in place, so an exception there
    leaves it set (parameters and state partly updated)."""
    run = TrainRun([], []) if run is None else run
    while run.step < steps:
        t0 = time.perf_counter()
        batch = batch_fn(run.step)
        loss, grads = fwd_bwd(params, batch)
        if run.opt_state is None:
            run.opt_state = opt_init_fn(params)
        run.torn = True
        update_fn(params, grads, run.opt_state)
        run.torn = False
        del grads, batch
        run.losses.append(loss.item())
        del loss
        run.step_s.append(time.perf_counter() - t0)
        run.step += 1
        if on_step is not None:
            on_step(run)
    return run


def make_estimator_hooks(cfg: ModelConfig, policy: TrainPolicy):
    """The (fwd_bwd, update, opt_init) triple xMem estimates from: the
    same code as the real step, ``policy.microbatches`` included."""
    opt, update_fn = _optimizer_and_update(policy)
    return make_fwd_bwd(cfg, policy.microbatches), update_fn, opt.init


# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Forward over the full prompt -> last-position logits. Grad mode
    is off inside the body, not through a decorator: a ``torch.no_grad``
    instance in the closure would leave the step no content digest."""
    def prefill_step(params, batch):
        with torch.no_grad():
            x = M.embed_inputs(params, batch, cfg)
            h = M.backbone(params, x, cfg, positions=torch.arange(
                x.shape[1], device=x.device))
            return M.logits_fn(params, h[:, -1:], cfg)
    return with_depth_plan(prefill_step, cfg, make_prefill_step, params_at)


def make_serve_step(cfg: ModelConfig, cache_len: int) -> Callable:
    """One-token decode against a cache of ``cache_len`` context (grad
    mode off inside the body, as in ``make_prefill_step``)."""
    def serve_step(params, cache, batch):
        with torch.no_grad():
            return M.decode_step(params, cache, batch, cache_len, cfg)
    return with_depth_plan(serve_step, cfg,
                           lambda c: make_serve_step(c, cache_len),
                           serving_args_at)
