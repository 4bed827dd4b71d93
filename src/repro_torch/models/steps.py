"""The step loops inside a layer, and the hook a loop probe sets on them
(``core/loops.py``).

The sLSTM and Mamba blocks run a Python loop over the steps of each
chunk and stack the steps' outputs, and the mLSTM block one over its
chunks, whose outputs it concatenates. They write that loop as

    for t in step_range(T):
        ...
        outs.append(y)
    ys = stack_steps(outs, T, dim)          # or cat_steps

which is ``range(T)`` and ``torch.stack`` (``torch.cat``) unless a probe
traces in this thread (``STEP_MARKS.hook`` set). A probe runs a long
loop for a few of its ``T`` steps (``hook.loop(T)`` yields them, marking
each step and the loop's end) and joins those steps' outputs into the
``T``-step shape (``_JoinSteps``), so nothing outside the loop changes
shape: the trace differs from the full one only by the steps it leaves
out.
"""
from __future__ import annotations

import threading

import torch

#: the step probes' hook (``core/loops.py``): while a probe traces in a
#: thread, ``STEP_MARKS.hook.loop(T)`` yields the steps a loop of ``T``
#: steps runs there, marking each step and the loop's end
STEP_MARKS = threading.local()


def step_range(T: int):
    """The steps a loop of ``T`` steps runs."""
    hook = getattr(STEP_MARKS, "hook", None)
    return range(T) if hook is None else hook.loop(T)


class _JoinSteps(torch.autograd.Function):
    """``torch.stack`` (``cat=False``) or ``torch.cat`` of the first
    ``k`` of ``T`` steps' outputs into the ``T``-step shape (the last
    output stands in for the rest), whose backward hands each of the
    ``k`` its slice of the gradient as the stack's or cat's backward
    does (views, nothing allocated)."""

    @staticmethod
    def forward(ctx, cat, T, dim, *xs):
        ctx.cat, ctx.dim, ctx.k = cat, dim, len(xs)
        ctx.sizes = [x.shape[dim] for x in xs]
        join = torch.cat if cat else torch.stack
        return join(list(xs) + [xs[-1]] * (T - len(xs)), dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.cat:
            return (None, None, None,
                    *(g.select(ctx.dim, i) for i in range(ctx.k)))
        offsets = [0]
        for n in ctx.sizes[:-1]:
            offsets.append(offsets[-1] + n)
        return (None, None, None, *(g.narrow(ctx.dim, o, n)
                                    for o, n in zip(offsets, ctx.sizes)))


def _join(cat: bool, xs: list, T: int, dim: int):
    if len(xs) == T:
        return (torch.cat if cat else torch.stack)(xs, dim)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _JoinSteps.apply(cat, T, dim, *xs)
    return (torch.cat if cat else torch.stack)(
        xs + [xs[-1]] * (T - len(xs)), dim)


def stack_steps(xs: list, T: int, dim: int = 0):
    """``torch.stack(xs, dim)`` of a loop of ``T`` steps; under a probe
    that ran fewer steps, their outputs in the ``T``-step shape."""
    return _join(False, xs, T, dim)


def cat_steps(xs: list, T: int, dim: int = 0):
    """``torch.cat(xs, dim)`` of a loop of ``T`` steps, as
    ``stack_steps``."""
    return _join(True, xs, T, dim)
