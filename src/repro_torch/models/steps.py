"""The step loops inside a layer, and the hook a loop probe sets on them
(``core/loops.py``).

The sLSTM and Mamba blocks run a Python loop over their chunks and,
inside each chunk, one over its steps; chunked attention one over the
query chunks and, inside each, one over the key chunks; the mLSTM block
one over its chunks. They write each loop as

    for t in step_range(T):
        ...
        outs.append(y)
    ys = stack_steps(outs, T, dim)          # or cat_steps; or nothing
                                            # when only a carry leaves

which is ``range(T)`` and ``torch.stack`` (``torch.cat``) unless a probe
traces in this thread (``STEP_MARKS.hook`` set). A probe runs a long
loop for a few of its ``T`` steps (``hook.loop(T, site)`` yields them:
the first ``k - 1`` and the last, so a last step shaped otherwise, a
shorter last chunk, runs in every probe; it marks each step and the
loop's end) and joins those steps' outputs into the ``T``-step shape
(``_JoinSteps``), so nothing outside the loop changes shape: the trace
differs from the full one only by the steps it leaves out. The hook
learns a loop's nesting from its call site (``site``), so the loop a
checkpoint's recompute runs again keeps its level.
"""
from __future__ import annotations

import sys
import threading

import torch

#: the step probes' hook (``core/loops.py``): while a probe traces in a
#: thread, ``STEP_MARKS.hook.loop(T, site)`` yields the steps a loop of
#: ``T`` steps runs there, marking each step and the loop's end
STEP_MARKS = threading.local()


def step_range(T: int):
    """The steps a loop of ``T`` steps runs."""
    hook = getattr(STEP_MARKS, "hook", None)
    if hook is None:
        return range(T)
    caller = sys._getframe(1)
    return hook.loop(T, (caller.f_code, caller.f_lineno))


def probe_steps(T: int, k: int) -> list[int]:
    """The steps a probe runs of a loop of ``T``: the first ``k - 1``
    and the last."""
    return list(range(k - 1)) + [T - 1]


def _padded(xs: list, T: int) -> list:
    """The outputs of a probe's steps (``probe_steps``) in the places
    of all ``T``: the one before the last stands in for the steps left
    out."""
    return xs[:-1] + [xs[-2]] * (T - len(xs)) + xs[-1:]


class _JoinSteps(torch.autograd.Function):
    """``torch.stack`` (``cat=False``) or ``torch.cat`` of a probe's
    ``k`` of ``T`` steps' outputs into the ``T``-step shape
    (``_padded``), whose backward hands each of the ``k`` its slice of
    the gradient as the stack's or cat's backward does (views, nothing
    allocated)."""

    @staticmethod
    def forward(ctx, cat, T, dim, *xs):
        ctx.cat, ctx.dim, ctx.k, ctx.T = cat, dim, len(xs), T
        padded = _padded(list(xs), T)
        ctx.sizes = [x.shape[dim] for x in padded]
        return (torch.cat if cat else torch.stack)(padded, dim)

    @staticmethod
    def backward(ctx, g):
        places = probe_steps(ctx.T, ctx.k)
        if not ctx.cat:
            return (None, None, None,
                    *(g.select(ctx.dim, i) for i in places))
        offsets = [0]
        for n in ctx.sizes[:-1]:
            offsets.append(offsets[-1] + n)
        return (None, None, None, *(g.narrow(ctx.dim, offsets[i],
                                             ctx.sizes[i]) for i in places))


def _join(cat: bool, xs: list, T: int, dim: int):
    if len(xs) == T:
        return (torch.cat if cat else torch.stack)(xs, dim)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _JoinSteps.apply(cat, T, dim, *xs)
    return (torch.cat if cat else torch.stack)(_padded(xs, T), dim)


def stack_steps(xs: list, T: int, dim: int = 0):
    """``torch.stack(xs, dim)`` of a loop of ``T`` steps; under a probe
    that ran fewer steps, their outputs in the ``T``-step shape."""
    return _join(False, xs, T, dim)


def cat_steps(xs: list, T: int, dim: int = 0):
    """``torch.cat(xs, dim)`` of a loop of ``T`` steps, as
    ``stack_steps``."""
    return _join(True, xs, T, dim)
