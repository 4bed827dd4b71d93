"""Memory Orchestrator — stage 3 of the xMem pipeline (paper §3.3).

Rewrites CPU-derived block lifecycles so they reflect the lifecycles the
blocks will have on the *target device*. The paper's five policies map to
JAX as follows (DESIGN.md §2):

1. Model parameters  -> persistent across the analyzed iterations.
2. Batch data        -> lives exactly one iteration.
3. Activations       -> keep tracer-derived lifetimes (the CPU-derived
                        interleaving approximates the device's).
4. Gradients         -> freed per ``grad_release``: ``at_update`` frees
                        them when the optimizer consumes them (the JAX
                        donation idiom; paper POS0) vs ``at_next_iter``
                        which keeps them alive until the next backward
                        pass rewrites them (grad-accumulation buffers /
                        ``zero_grad`` at iteration start; paper POS1 —
                        Fig. 1's memory-doubling case).
5. Optimizer state   -> persistent from iteration 1 onward (why the
                        paper — and we — analyze >= 2 iterations).

XLA-specific passes the original (eager PyTorch) pipeline does not need:

6. donation          -> outputs aliased onto donated inputs (new params /
                        opt state reuse the old buffers; no double count).
7. fusion folding    -> short-lived outputs of fusible elementwise ops
                        never materialize in HBM (XLA fuses them); they
                        are dropped below a size threshold.
8. collective inject -> distributed estimation (paper §6.2/6.4's
                        "inject simulated allreduce buffers"): adds
                        COLLECTIVE blocks for gradient reduction buckets
                        and TP gather temporaries.
9. sharding          -> per-device sizes via shard factors from the
                        sharding engine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from .events import BlockKind, BlockLifecycle, MemorySpace, Phase

# Elementwise/layout primitives XLA reliably fuses into consumers —
# their outputs typically never hit HBM as standalone buffers.
FUSIBLE_OPS = frozenset({
    "add", "sub", "mul", "div", "neg", "exp", "log", "tanh", "logistic",
    "max", "min", "pow", "integer_pow", "sqrt", "rsqrt", "abs", "sign",
    "convert_element_type", "select_n", "broadcast_in_dim", "reshape",
    "transpose", "squeeze", "expand_dims", "stop_gradient", "and", "or",
    "not", "xor", "eq", "ne", "ge", "gt", "le", "lt", "clamp", "erf",
    "floor", "ceil", "round", "is_finite", "copy", "real", "imag",
    "slice", "rev", "iota", "cos", "sin", "cumsum", "cumlogsumexp",
})


@dataclasses.dataclass(frozen=True)
class OffloadPlan:
    """A-priori host-offload schedule (TENSILE direction).

    TENSILE schedules tensor swapping reactively at runtime; because the
    event engine replays on CPU, the same swaps are decided here a
    priori, as a lifecycle rewrite: offloaded blocks change their
    ``space`` to a host space and paired transfer blocks (op
    ``offload_out`` / ``fetch_in``) model the device-side staging the
    copies need. The replay engine then reports per-space peaks and the
    roofline cost model charges the transfer bytes over PCIe.

    * ``optimizer_state`` — park persistent OPT_STATE on the host; a
      device staging copy exists only during each optimizer phase
      (fetched in before the update, written back after).
    * ``activations`` — fraction (by bytes, largest-first) of eligible
      saved activations offloaded between production (forward) and
      consumption (backward). Rematerialization interacts naturally:
      stronger remat policies save fewer/smaller activations, so the
      eligible set shrinks and with it the transfer cost.
    """

    optimizer_state: bool = False
    activations: float = 0.0          # 0..1, fraction of eligible bytes
    space: MemorySpace = MemorySpace.HOST_PINNED
    min_block_bytes: int = 1 << 16    # never offload tiny blocks
    stage_ticks: int = 1              # device residency of a staging copy

    @property
    def enabled(self) -> bool:
        return self.optimizer_state or self.activations > 0.0


@dataclasses.dataclass
class OrchestratorPolicy:
    """Knobs for lifecycle rewriting."""

    # "at_update"    - grads live until the optimizer phase consumes them
    #                  (PyTorch-eager semantics; paper POS0-ish)
    # "at_next_iter" - grads survive into the next iteration (accumulation
    #                  buffers / zero_grad at iteration start; paper POS1)
    # "eager_fused"  - XLA fuses per-leaf updates into the backward pass,
    #                  so each grad dies ~immediately after production.
    #                  Selected automatically when the update is per-leaf
    #                  (no cross-gradient coupling such as global-norm
    #                  clipping) — see estimator.update_grad_coupling.
    # "auto"         - estimator picks eager_fused vs at_update by taint
    #                  analysis of the update jaxpr.
    # "after_update" - grads live through the optimizer phase and die
    #                  when the step ends (eager PyTorch: the update
    #                  reads them leaf by leaf; the port's default).
    grad_release: str = "auto"
    eager_fuse_window: int = 6           # events a fused grad survives
    donate_params: bool = True
    donate_opt_state: bool = True
    # Step outputs (loss/metrics and, when donation is off, the freshly
    # written params/opt state) are overwritten by the next iteration's
    # outputs in a real loop — the old buffers die once replaced. Without
    # this pass every iteration leaks its outputs into "persistent",
    # which (a) inflates multi-iteration estimates (grossly so for
    # non-donated updates: + params x N) and (b) makes allocator state
    # drift forever, defeating steady-state replay. The final iteration's
    # outputs stay live (they are the job's results).
    release_outputs_next_iter: bool = True
    fusion_folding: bool = True
    fusion_max_lifetime: int = 8          # events a fusible temp may span
    fusion_min_bytes: int = 0             # fold regardless of size by default
    keep_unattributed: bool = True
    # Mixed-precision optimizers upcast each gradient to f32; observed
    # XLA schedules materialize these working copies together across
    # leaves during the update phase. Modeled as synthetic blocks of
    # grad_size * upcast_factor spanning the optimizer phase (ablation
    # benchmark quantifies the contribution).
    optimizer_upcast_coexist: bool = True
    upcast_factor: float = 2.0            # bf16 grads -> f32 copies
    # Backend scheduling-slack calibration (paper's Fig-6 loop made
    # explicit): one constant multiplying *transient* block sizes,
    # fitted once per target backend/runtime from a small calibration
    # set (XMemEstimator.calibrate). 1.0 = uncalibrated. Unlike
    # data-driven estimators this is model-independent — it captures
    # the runtime's buffering behavior, not the workload.
    transient_scale: float = 1.0
    # Host-offload schedule (None = everything stays in device HBM).
    # Applied as a separate pass *after* run/run_unfused so the fused
    # pipeline stays output-identical to its oracle.
    offload: OffloadPlan | None = None


@dataclasses.dataclass
class CollectiveSpec:
    """One injected communication buffer (distributed estimation).

    ``size`` is a fixed per-device byte count when ``source`` is empty.
    With ``source`` set, the buffer is sized at injection time from the
    composition's *actual sharded tensors* (per mesh axis, not a fixed
    factor): the largest per-device block of the named kind in the
    iteration, times ``scale`` (e.g. the axis size for an all-gather
    that materializes the unsharded tensor). ``axis``/``collective`` are
    attribution metadata (which mesh axis and primitive the buffer
    models)."""

    name: str
    size: int              # bytes per device (fixed-size specs)
    phase: Phase
    at: str = "phase_start"  # or "phase_end"
    persistent: bool = False
    axis: str = ""           # mesh axis the collective runs over
    collective: str = ""     # all_reduce | all_gather | reduce_scatter
    source: str = ""         # "" fixed | "grads" | "params" | "activations"
    scale: float = 1.0       # multiplier on the derived per-device size


class MemoryOrchestrator:
    def __init__(self, policy: OrchestratorPolicy | None = None):
        self.policy = policy or OrchestratorPolicy()

    # -- individual passes ---------------------------------------------------
    def mark_persistent(self, blocks: list[BlockLifecycle],
                        kinds=(BlockKind.PARAM, BlockKind.OPT_STATE)
                        ) -> list[BlockLifecycle]:
        return [dataclasses.replace(b, free_t=None)
                if b.block_kind in kinds else b for b in blocks]

    def batch_per_iteration(self, blocks: list[BlockLifecycle],
                            iteration_ends: dict[int, int]
                            ) -> list[BlockLifecycle]:
        """INPUT blocks die at their iteration's boundary marker."""
        out = []
        for b in blocks:
            if b.block_kind is BlockKind.INPUT:
                end = iteration_ends.get(b.iteration)
                if end is not None:
                    b = dataclasses.replace(b, free_t=end)
            out.append(b)
        return out

    def release_gradients(self, blocks: list[BlockLifecycle],
                          update_start: dict[int, int],
                          next_bwd_start: dict[int, int],
                          iteration_ends: dict[int, int] | None = None
                          ) -> list[BlockLifecycle]:
        """Apply grad_release (the paper's zero_grad-placement semantics)."""
        out = []
        for b in blocks:
            # Only *persistent* GRAD blocks are true gradient outputs whose
            # release the framework controls; GRAD-classified backward
            # intermediates keep their tracer-derived lifetimes.
            if b.block_kind is BlockKind.GRAD and b.free_t is None:
                mode = self.policy.grad_release
                if mode in ("auto",):  # estimator resolves auto; fall back
                    mode = "at_update"
                if mode == "eager_fused":
                    us = update_start.get(b.iteration)
                    if b.op == "scan_ys":
                        # stacked-layer grads are backward-scan output
                        # buffers accumulated across the whole loop —
                        # they cannot die before the update consumes them
                        t = us
                    else:
                        t = b.alloc_t + self.policy.eager_fuse_window
                        if us is not None:
                            t = min(t, us)
                elif mode == "at_update":
                    t = update_start.get(b.iteration)
                elif mode == "after_update":
                    t = (iteration_ends or {}).get(b.iteration)
                else:  # at_next_iter: grads survive into the next iteration
                    t = next_bwd_start.get(b.iteration + 1)
                b = dataclasses.replace(b, free_t=t)  # None -> persistent
            out.append(b)
        return out

    def apply_donation(self, blocks: list[BlockLifecycle]
                       ) -> list[BlockLifecycle]:
        """Drop OUTPUT blocks that alias donated persistent inputs.

        With ``donate_argnums`` the updated params/opt-state are written
        into the old buffers; a simulator that allocates both
        double-counts — the classic over-estimation DNNMem-style static
        analysis exhibits (evaluated in benchmarks/ablation).
        """
        if not (self.policy.donate_params or self.policy.donate_opt_state):
            return blocks
        _PARAM, _OPT, _OUT = (BlockKind.PARAM, BlockKind.OPT_STATE,
                              BlockKind.OUTPUT)
        persistent_sizes: dict[int, int] = {}
        for b in blocks:
            bk = b.block_kind
            if (bk is _PARAM or bk is _OPT) and b.free_t is None:
                persistent_sizes[b.size] = persistent_sizes.get(b.size, 0) + 1
        # every iteration's update writes into the same donated buffers, so
        # the aliasing budget applies per iteration, not once for the trace
        budgets: dict[int, dict[int, int]] = {}
        out = []
        append = out.append
        for b in blocks:
            if b.block_kind is _OUT:
                budget = budgets.get(b.iteration)
                if budget is None:
                    budget = budgets[b.iteration] = dict(persistent_sizes)
                if budget.get(b.size, 0) > 0:
                    budget[b.size] -= 1
                    continue  # aliased: no new allocation
            append(b)
        return out

    def release_step_outputs(self, blocks: list[BlockLifecycle],
                             iteration_ends: dict[int, int]
                             ) -> list[BlockLifecycle]:
        """Free iteration i's surviving OUTPUT blocks at iteration i+1's
        end (when the next step's outputs have replaced them). Outputs of
        the final iteration — no successor in ``iteration_ends`` — stay
        persistent."""
        out = []
        for b in blocks:
            if b.block_kind is BlockKind.OUTPUT and b.free_t is None:
                end = iteration_ends.get(b.iteration + 1)
                if end is not None:
                    b = dataclasses.replace(b, free_t=end)
            out.append(b)
        return out

    def fold_fused(self, blocks: list[BlockLifecycle]) -> list[BlockLifecycle]:
        """Drop blocks XLA fusion would never materialize."""
        if not self.policy.fusion_folding:
            return blocks
        p = self.policy
        out = []
        for b in blocks:
            if (b.op in FUSIBLE_OPS
                    and b.free_t is not None
                    and (b.free_t - b.alloc_t) <= p.fusion_max_lifetime
                    and b.size >= p.fusion_min_bytes
                    and b.block_kind in (BlockKind.ACTIVATION, BlockKind.TEMP)):
                continue
            out.append(b)
        return out

    def inject_optimizer_upcasts(self, blocks: list[BlockLifecycle],
                                 update_start: dict[int, int],
                                 iteration_ends: dict[int, int]
                                 ) -> list[BlockLifecycle]:
        """Synthetic f32 working copies of gradients during the update."""
        if not self.policy.optimizer_upcast_coexist:
            return blocks
        out = list(blocks)
        bid = -100_000
        for b in blocks:
            if b.block_kind is not BlockKind.GRAD:
                continue
            us = update_start.get(b.iteration)
            end = iteration_ends.get(b.iteration)
            if us is None or end is None or us >= end:
                continue
            # only true gradient outputs (freed at/after update start)
            if b.free_t is not None and b.free_t < us:
                continue
            out.append(BlockLifecycle(
                bid, int(b.size * self.policy.upcast_factor), us, end,
                b.iteration, Phase.OPTIMIZER, "grad_upcast", b.scope,
                BlockKind.TEMP, b.shard_factor, b.shape))
            bid -= 1
        return out

    def inject_collectives(self, blocks: list[BlockLifecycle],
                           specs: Sequence[CollectiveSpec],
                           phase_bounds: dict[tuple[int, str], tuple[int, int]],
                           num_iterations: int,
                           shard_factor_fn: Callable | None = None
                           ) -> list[BlockLifecycle]:
        """Add COLLECTIVE buffers at phase starts/ends per iteration.

        Dynamic specs (``source`` set) are sized from the composition's
        actual blocks at their *per-device* size — the sharding pass runs
        after injection, so the factor function is applied here to the
        candidate source blocks (collective buffers themselves stay
        factor-1: they are already per-device quantities)."""
        if not specs:
            return blocks
        dynamic = [s for s in specs if s.source]
        src_max: dict[tuple[int, str], int] = {}
        if dynamic:
            wanted = {s.source for s in dynamic}

            def per_device(b: BlockLifecycle) -> int:
                if shard_factor_fn is not None:
                    f = max(shard_factor_fn(b), 1.0)
                    if f != 1.0:
                        return max(int(b.size / f), 1) if b.size else 0
                return b.sharded_size

            for b in blocks:
                k = b.block_kind
                if k is BlockKind.GRAD:
                    source = "grads"
                elif k is BlockKind.PARAM:
                    source = "params"
                elif k is BlockKind.ACTIVATION:
                    source = "activations"
                else:
                    continue
                if source not in wanted:
                    continue
                # persistent params count for every iteration
                its = (range(num_iterations) if k is BlockKind.PARAM
                       and b.free_t is None else (b.iteration,))
                s = per_device(b)
                for it in its:
                    key = (it, source)
                    if s > src_max.get(key, 0):
                        src_max[key] = s
        out = list(blocks)
        bid = -1  # negative ids: synthetic blocks
        for it in range(num_iterations):
            for s in specs:
                key = (it, s.phase.value)
                if key not in phase_bounds:
                    continue
                size = s.size
                if s.source:
                    size = int(src_max.get((it, s.source), 0) * s.scale)
                    if size <= 0:
                        continue
                start, end = phase_bounds[key]
                if s.at == "phase_start":
                    t0, t1 = start, end
                else:
                    # end-of-phase staging (gradient all-reduce /
                    # reduce-scatter): allocated one tick before the
                    # boundary so it coexists with tensors freed exactly
                    # at phase end (frees sort before allocs at equal t)
                    t0, t1 = max(start, end - 1), end
                out.append(BlockLifecycle(
                    bid, size, t0, None if s.persistent else t1,
                    it, s.phase, "collective", s.name, BlockKind.COLLECTIVE))
                bid -= 1
        return out

    def apply_transient_scale(self, blocks: list[BlockLifecycle]
                              ) -> list[BlockLifecycle]:
        """Scale transient (non-persistent, non-input) blocks by the
        backend calibration constant."""
        s = self.policy.transient_scale
        if s == 1.0:
            return blocks
        out = []
        for b in blocks:
            if b.free_t is not None and b.block_kind in (
                    BlockKind.ACTIVATION, BlockKind.TEMP, BlockKind.GRAD):
                b = dataclasses.replace(b, size=int(b.size * s))
            out.append(b)
        return out

    def apply_sharding(self, blocks: list[BlockLifecycle],
                       factor_fn: Callable[[BlockLifecycle], float]
                       ) -> list[BlockLifecycle]:
        return [dataclasses.replace(b, shard_factor=max(factor_fn(b), 1.0))
                for b in blocks]

    def apply_offload(self, blocks: list[BlockLifecycle],
                      update_start: dict[int, int] | None = None,
                      iteration_ends: dict[int, int] | None = None,
                      ) -> tuple[list[BlockLifecycle], dict | None]:
        """Rewrite lifecycles per the policy's :class:`OffloadPlan`.

        Runs *after* ``run``/``run_unfused`` (so the fused pipeline stays
        identical to its oracle) and before replay. Two rewrites:

        * optimizer-state: persistent OPT_STATE blocks move to the host
          space; each optimizer phase gets a device ``fetch_in`` staging
          copy spanning ``[update_start, iteration_end]`` (the state is
          fetched before the update and written back after — 2x bytes
          over the interconnect per iteration).
        * activations: eligible saved activations (device-resident,
          freed, >= ``min_block_bytes``, lifetime long enough to round-
          trip) are picked largest-first per iteration until the
          ``activations`` byte fraction is covered. The original block's
          device residency shrinks to a copy-out window at its head; a
          host block (op ``offload_out``) holds the bulk residency, and
          a device ``fetch_in`` staging block covers the copy-back
          window before the backward pass consumes it.

        Synthetic blocks get ids descending from -200000 (below the
        upcast namespace). Returns ``(blocks, stats)``; stats is None
        when no offload is configured. Transfer accounting uses
        per-device (sharded) sizes — those are the bytes that cross
        PCIe on each device.
        """
        plan = self.policy.offload
        if plan is None or not plan.enabled:
            return blocks, None
        update_start = update_start or {}
        iteration_ends = iteration_ends or {}
        _DEV = MemorySpace.DEVICE_HBM
        out: list[BlockLifecycle] = []
        extra: list[BlockLifecycle] = []
        bid = -200_000
        transfers: dict[int, int] = {}  # per-iteration transfer bytes
        opt_blocks = opt_bytes = 0
        act_blocks = act_bytes = 0
        min_life = 2 * plan.stage_ticks + 1

        # per-iteration activation selection: largest-first until the
        # requested byte fraction of the eligible set is covered
        selected: set[int] = set()
        if plan.activations > 0.0:
            eligible: dict[int, list[BlockLifecycle]] = {}
            for b in blocks:
                if (b.block_kind is BlockKind.ACTIVATION
                        and b.space is _DEV
                        and b.free_t is not None
                        and b.size >= plan.min_block_bytes
                        and (b.free_t - b.alloc_t) > min_life):
                    eligible.setdefault(b.iteration, []).append(b)
            for it, cands in eligible.items():
                total = sum(c.size for c in cands)
                target = plan.activations * total
                taken = 0
                cands.sort(key=lambda c: (-c.size, c.alloc_t, c.block_id))
                for c in cands:
                    if taken >= target:
                        break
                    selected.add(id(c))
                    taken += c.size

        for b in blocks:
            if (plan.optimizer_state
                    and b.block_kind is BlockKind.OPT_STATE
                    and b.space is _DEV
                    and b.free_t is None
                    and b.size >= plan.min_block_bytes):
                out.append(dataclasses.replace(b, space=plan.space))
                opt_blocks += 1
                opt_bytes += b.sharded_size
                for it, us in update_start.items():
                    end = iteration_ends.get(it)
                    if us is None or end is None or us >= end:
                        continue
                    extra.append(BlockLifecycle(
                        bid, b.size, us, end, it, Phase.OPTIMIZER,
                        "fetch_in", b.scope, BlockKind.OPT_STATE,
                        b.shard_factor, b.shape))
                    bid -= 1
                    transfers[it] = (transfers.get(it, 0)
                                     + 2 * b.sharded_size)
                continue
            if id(b) in selected:
                head_end = b.alloc_t + plan.stage_ticks
                tail_start = max(b.free_t - plan.stage_ticks, head_end)
                out.append(dataclasses.replace(b, free_t=head_end))
                extra.append(BlockLifecycle(
                    bid, b.size, b.alloc_t, b.free_t, b.iteration,
                    b.phase, "offload_out", b.scope, b.block_kind,
                    b.shard_factor, b.shape, plan.space))
                bid -= 1
                extra.append(BlockLifecycle(
                    bid, b.size, tail_start, b.free_t, b.iteration,
                    b.phase, "fetch_in", b.scope, b.block_kind,
                    b.shard_factor, b.shape))
                bid -= 1
                act_blocks += 1
                act_bytes += b.sharded_size
                transfers[b.iteration] = (
                    transfers.get(b.iteration, 0) + 2 * b.sharded_size)
                continue
            out.append(b)
        out.extend(extra)
        # steady-state transfer bytes: the cycle iteration (1) when the
        # composition has one, else the heaviest observed iteration
        steady = transfers.get(1)
        if steady is None:
            steady = max(transfers.values(), default=0)
        stats = {
            "opt_state_blocks": opt_blocks,
            "opt_state_bytes": opt_bytes,
            "activation_blocks": act_blocks,
            "activation_bytes": act_bytes,
            "transfer_bytes_per_iter": steady,
            "space": plan.space.value,
        }
        return out, stats

    # -- composite ------------------------------------------------------------
    def run_unfused(self, blocks: list[BlockLifecycle], *,
                    iteration_ends: dict[int, int] | None = None,
                    update_start: dict[int, int] | None = None,
                    next_bwd_start: dict[int, int] | None = None,
                    collective_specs: Sequence[CollectiveSpec] = (),
                    phase_bounds: dict | None = None,
                    num_iterations: int = 1,
                    shard_factor_fn=None) -> list[BlockLifecycle]:
        """The pass pipeline as individual passes — the readable form
        ``run`` is a fusion of (and the oracle it is tested against)."""
        # fold first: fused temps are never touched by the lifecycle
        # passes below (they act on PARAM/OPT/GRAD/INPUT/OUTPUT or on
        # persistent blocks, which fusible short-lived temps are not), so
        # dropping them up front shrinks every subsequent pass
        blocks = self.fold_fused(blocks)
        blocks = self.mark_persistent(blocks)
        if iteration_ends:
            blocks = self.batch_per_iteration(blocks, iteration_ends)
        if update_start is not None:
            blocks = self.release_gradients(blocks, update_start,
                                            next_bwd_start or {},
                                            iteration_ends)
            if iteration_ends:
                blocks = self.inject_optimizer_upcasts(
                    blocks, update_start, iteration_ends)
        blocks = self.apply_donation(blocks)
        if self.policy.release_outputs_next_iter and iteration_ends:
            blocks = self.release_step_outputs(blocks, iteration_ends)
        blocks = self.apply_transient_scale(blocks)
        if collective_specs and phase_bounds:
            blocks = self.inject_collectives(blocks, collective_specs,
                                             phase_bounds, num_iterations,
                                             shard_factor_fn)
        if shard_factor_fn is not None:
            blocks = self.apply_sharding(blocks, shard_factor_fn)
        return blocks

    def run(self, blocks: list[BlockLifecycle], *,
            iteration_ends: dict[int, int] | None = None,
            update_start: dict[int, int] | None = None,
            next_bwd_start: dict[int, int] | None = None,
            collective_specs: Sequence[CollectiveSpec] = (),
            phase_bounds: dict | None = None,
            num_iterations: int = 1,
            shard_factor_fn: Callable[[BlockLifecycle], float] | None = None,
            ) -> list[BlockLifecycle]:
        """Fused pass pipeline — output-identical to ``run_unfused``
        (asserted by tests/test_columnar.py) but two list traversals
        instead of eight. This is the estimator's per-point hot loop, so
        the per-block passes (fold, persistence, batch, grad release,
        upcast injection) run in one pass that also collects the donation
        budget, and the list-order-dependent tail (donation, output
        release, transient scale) runs in a second."""
        p = self.policy
        iteration_ends = iteration_ends or {}
        update_start_d = update_start if update_start is not None else None
        next_bwd = next_bwd_start or {}
        do_batch = bool(iteration_ends)
        do_upcast = (update_start is not None and bool(iteration_ends)
                     and p.optimizer_upcast_coexist)
        grad_mode = p.grad_release
        if grad_mode in ("auto",):
            grad_mode = "at_update"
        _PARAM, _OPT, _GRAD = (BlockKind.PARAM, BlockKind.OPT_STATE,
                               BlockKind.GRAD)
        _IN, _OUT, _ACT, _TMP = (BlockKind.INPUT, BlockKind.OUTPUT,
                                 BlockKind.ACTIVATION, BlockKind.TEMP)
        fold = p.fusion_folding
        fuse_life, fuse_min = p.fusion_max_lifetime, p.fusion_min_bytes
        out: list[BlockLifecycle] = []
        append = out.append
        upcast_blocks: list[BlockLifecycle] = []
        persistent_sizes: dict[int, int] = {}
        for b in blocks:
            kind = b.block_kind
            free_t = b.free_t
            # fold_fused
            if (fold and free_t is not None and b.op in FUSIBLE_OPS
                    and (free_t - b.alloc_t) <= fuse_life
                    and b.size >= fuse_min and (kind is _ACT or kind is _TMP)):
                continue
            # mark_persistent
            if kind is _PARAM or kind is _OPT:
                if free_t is not None:
                    b = dataclasses.replace(b, free_t=None)
                persistent_sizes[b.size] = \
                    persistent_sizes.get(b.size, 0) + 1
                append(b)
                continue
            # batch_per_iteration
            if do_batch and kind is _IN:
                end = iteration_ends.get(b.iteration)
                if end is not None:
                    b = dataclasses.replace(b, free_t=end)
                append(b)
                continue
            # release_gradients (+ upcast injection bookkeeping)
            if kind is _GRAD and update_start_d is not None:
                if free_t is None:
                    if grad_mode == "eager_fused":
                        us = update_start_d.get(b.iteration)
                        if b.op == "scan_ys":
                            t = us
                        else:
                            t = b.alloc_t + p.eager_fuse_window
                            if us is not None:
                                t = min(t, us)
                    elif grad_mode == "at_update":
                        t = update_start_d.get(b.iteration)
                    elif grad_mode == "after_update":
                        t = iteration_ends.get(b.iteration)
                    else:  # at_next_iter
                        t = next_bwd.get(b.iteration + 1)
                    b = dataclasses.replace(b, free_t=t)
                    free_t = t
                if do_upcast:
                    us = update_start_d.get(b.iteration)
                    end = iteration_ends.get(b.iteration)
                    if (us is not None and end is not None and us < end
                            and (free_t is None or free_t >= us)):
                        upcast_blocks.append((b, us, end))
                append(b)
                continue
            append(b)
        # inject_optimizer_upcasts appends synthetic blocks at the tail,
        # in GRAD block order, ids descending from -100000
        bid = -100_000
        for b, us, end in upcast_blocks:
            append(BlockLifecycle(
                bid, int(b.size * p.upcast_factor), us, end,
                b.iteration, Phase.OPTIMIZER, "grad_upcast", b.scope,
                BlockKind.TEMP, b.shard_factor, b.shape))
            bid -= 1
        # second traversal: donation, output release, transient scale
        do_donate = p.donate_params or p.donate_opt_state
        do_release_out = p.release_outputs_next_iter and bool(iteration_ends)
        scale = p.transient_scale
        budgets: dict[int, dict[int, int]] = {}
        blocks2: list[BlockLifecycle] = []
        append2 = blocks2.append
        for b in out:
            if b.block_kind is _OUT:
                if do_donate:
                    budget = budgets.get(b.iteration)
                    if budget is None:
                        budget = budgets[b.iteration] = \
                            dict(persistent_sizes)
                    if budget.get(b.size, 0) > 0:
                        budget[b.size] -= 1
                        continue          # aliased: no new allocation
                if do_release_out and b.free_t is None:
                    end = iteration_ends.get(b.iteration + 1)
                    if end is not None:
                        b = dataclasses.replace(b, free_t=end)
            if (scale != 1.0 and b.free_t is not None
                    and b.block_kind in (_ACT, _TMP, _GRAD)):
                b = dataclasses.replace(b, size=int(b.size * scale))
            append2(b)
        blocks = blocks2
        if collective_specs and phase_bounds:
            blocks = self.inject_collectives(blocks, collective_specs,
                                             phase_bounds, num_iterations,
                                             shard_factor_fn)
        if shard_factor_fn is not None:
            blocks = self.apply_sharding(blocks, shard_factor_fn)
        return blocks


# -- request-driven serving workloads ----------------------------------------
@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One serving request of a :class:`RequestStream`.

    Ticks are discrete scheduler steps: the request arrives at
    ``arrival_t``, prefills ``prompt_len`` tokens the tick it joins a
    batch slot, then decodes one token per tick for ``decode_len``
    ticks and leaves. ``shared_prefix_len`` marks how many of its
    prompt tokens are the stream-wide common prefix (system prompt /
    few-shot header) eligible for prefix-cache page sharing.
    ``evict_at`` scripts a preemption: at that absolute tick the
    request is evicted (all private pages freed), re-queues, and
    re-prefills everything generated so far when a slot frees.
    """

    arrival_t: int
    prompt_len: int
    decode_len: int
    shared_prefix_len: int = 0
    evict_at: int | None = None


@dataclasses.dataclass(frozen=True)
class ServingKnobs:
    """The serving-runtime knobs the planner searches.

    ``page_size`` is the KV block granularity in tokens;
    ``max_concurrent`` caps in-flight sequences (arrivals queue);
    ``kv_dtype_bytes`` is the stored KV element width (2 = bf16,
    1 = fp8) scaling the per-token page bytes relative to the traced
    base dtype; ``prefix_cache`` enables shared-prompt page dedup;
    ``speculative_k`` reserves a k-token draft-KV scratch block per
    active request (speculative decoding).
    """

    page_size: int = 16
    max_concurrent: int = 8
    kv_dtype_bytes: int = 2
    prefix_cache: bool = True
    speculative_k: int = 0

    def signature(self) -> tuple:
        """Hashable identity for degradation-family separation."""
        return (self.page_size, self.max_concurrent,
                self.kv_dtype_bytes, self.prefix_cache,
                self.speculative_k)


@dataclasses.dataclass(frozen=True)
class RequestStream:
    """A concrete request timeline (the serving workload)."""

    requests: tuple = ()

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def max_seq_len(self) -> int:
        """Longest total sequence any request reaches — what a
        monolithic (non-paged) cache must provision per slot."""
        return max((r.prompt_len + r.decode_len for r in self.requests),
                   default=0)


@dataclasses.dataclass(frozen=True)
class RequestMix:
    """A request-mix distribution: deterministic stand-in for arrival
    randomness so serving decisions reproduce bit-identically.

    ``buckets`` is ``((prompt_len, decode_len, count), ...)``;
    ``stream()`` expands it round-robin across buckets with one arrival
    every ``arrival_period`` ticks — a worst-case-dense, fully
    deterministic timeline (no RNG anywhere near an admission answer).
    """

    buckets: tuple
    arrival_period: int = 1
    shared_prefix_len: int = 0

    def stream(self) -> RequestStream:
        remaining = [[int(p), int(d), int(c)] for p, d, c in self.buckets
                     if c > 0]
        reqs, t, i = [], 0, 0
        while remaining:
            b = remaining[i % len(remaining)]
            reqs.append(RequestSpec(
                arrival_t=t, prompt_len=b[0], decode_len=b[1],
                shared_prefix_len=min(self.shared_prefix_len, b[0])))
            b[2] -= 1
            if b[2] == 0:
                remaining.remove(b)
            t += self.arrival_period
            i += 1
        return RequestStream(tuple(reqs))

    @property
    def n_requests(self) -> int:
        return sum(c for _p, _d, c in self.buckets)

    def to_json(self) -> dict:
        return {"buckets": [list(b) for b in self.buckets],
                "arrival_period": self.arrival_period,
                "shared_prefix_len": self.shared_prefix_len}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class ContinuousBatchingScheduler:
    """Lower a :class:`RequestStream` to a request-driven allocation
    stream (:class:`~repro.core.events.RequestBlocks`).

    This is the serving analogue of the periodic composer: a CPU-side
    replay of the continuous-batching runloop that emits one
    ``BlockLifecycle`` per KV page / scratch / per-request state block
    at the exact tick it is allocated and freed, so the allocator
    simulator sees the same dynamic pressure a paged-attention server
    produces — page-granular allocations (never one monolithic cache
    tensor), prefix-shared pages refcounted across requests, and
    speculative-decoding scratch riding along per active sequence.

    Determinism contract: identical (stream, knobs, byte parameters)
    inputs produce an identical lifecycle list — serving decisions and
    counter-offers reproduce bit-identically from cold services.
    """

    #: runaway guard: a lowering may not emit more lifecycles than this
    MAX_BLOCKS = 2_000_000

    def __init__(self, knobs: ServingKnobs = ServingKnobs()):
        if knobs.page_size <= 0 or knobs.max_concurrent <= 0 \
                or knobs.kv_dtype_bytes <= 0:
            raise ValueError(f"invalid serving knobs: {knobs}")
        self.knobs = knobs

    def page_bytes(self, kv_bytes_per_token: int,
                   base_dtype_bytes: int = 2) -> int:
        """Device bytes of one KV page under these knobs' dtype."""
        k = self.knobs
        tok = _ceil_div(int(kv_bytes_per_token) * k.kv_dtype_bytes,
                        max(int(base_dtype_bytes), 1))
        return k.page_size * max(tok, 1)

    def lower(self, stream: RequestStream, kv_bytes_per_token: int, *,
              resident_bytes_per_request: int = 0,
              base_dtype_bytes: int = 2):
        """Run the continuous-batching timeline; return RequestBlocks.

        ``kv_bytes_per_token`` is the per-token KV footprint at the
        model's base dtype (all layers summed); the knobs' dtype scales
        it. ``resident_bytes_per_request`` covers non-paged per-slot
        state (SSM / hybrid recurrent state — constant-size, not
        length-dependent, so it never pages).
        """
        from .events import RequestBlocks
        k = self.knobs
        page_b = self.page_bytes(kv_bytes_per_token, base_dtype_bytes)
        tok_b = max(page_b // k.page_size, 1)
        scratch_b = k.speculative_k * tok_b

        blocks: list[BlockLifecycle] = []
        next_bid = [1]

        def open_block(t: int, size: int, kind: BlockKind, op: str,
                       scope: str) -> int:
            bid = next_bid[0]
            next_bid[0] += 1
            blocks.append(BlockLifecycle(
                bid, int(size), int(t), None, 0, Phase.DECODE, op,
                scope, kind))
            return len(blocks) - 1

        def close_block(idx: int, t: int) -> None:
            blocks[idx] = dataclasses.replace(blocks[idx], free_t=int(t))

        # shared prefix pages: page index -> [block idx, refcount]
        shared_pages: dict[int, list] = {}
        live_now = [0]

        def acquire_shared(t: int, n_pages: int) -> list[int]:
            out = []
            for p in range(n_pages):
                ent = shared_pages.get(p)
                if ent is None or blocks[ent[0]].free_t is not None:
                    ent = [open_block(t, page_b, BlockKind.CACHE,
                                      "kv_page",
                                      f"serving/prefix/page{p}"), 0]
                    shared_pages[p] = ent
                    live_now[0] += page_b
                ent[1] += 1
                out.append(p)
            return out

        def release_shared(t: int, pages: list[int]) -> None:
            for p in pages:
                ent = shared_pages[p]
                ent[1] -= 1
                if ent[1] == 0:
                    close_block(ent[0], t)
                    live_now[0] -= page_b

        class _Active:
            __slots__ = ("r", "ridx", "tokens", "pages", "shared",
                         "aux", "decoded")

            def __init__(self):
                self.pages: list[int] = []      # private page block idxs
                self.shared: list[int] = []     # shared page indices
                self.aux: list[int] = []        # scratch/state block idxs

        waiting = sorted(range(len(stream.requests)),
                         key=lambda i: (stream.requests[i].arrival_t, i))
        waiting = list(waiting)
        requeued: list[int] = []            # evicted, FIFO, by index
        evicted_tokens: dict[int, int] = {}  # ridx -> tokens at eviction
        evicted_once: set[int] = set()       # scripted evictions fire once
        active: list[_Active] = []
        occupancy: list[int] = []
        live_paged: list[int] = []          # per-tick paged+aux live bytes
        evictions = 0
        t = 0

        def open_counted(t, size, kind, op, scope):
            live_now[0] += int(size)
            return open_block(t, size, kind, op, scope)

        def close_counted(idx, t):
            live_now[0] -= blocks[idx].size
            close_block(idx, t)

        def join(ridx: int, t: int) -> _Active:
            r = stream.requests[ridx]
            a = _Active()
            a.r, a.ridx = r, ridx
            a.tokens = evicted_tokens.pop(ridx, r.prompt_len)
            a.decoded = max(a.tokens - r.prompt_len, 0)
            shared_tokens = (r.shared_prefix_len if k.prefix_cache
                             else 0)
            n_shared = min(shared_tokens, a.tokens) // k.page_size
            if n_shared:
                a.shared = acquire_shared(t, n_shared)
            n_total = _ceil_div(a.tokens, k.page_size) if a.tokens else 0
            for p in range(len(a.shared), max(n_total, len(a.shared))):
                a.pages.append(open_counted(
                    t, page_b, BlockKind.CACHE, "kv_page",
                    f"serving/req{ridx}/page{p}"))
            if resident_bytes_per_request:
                a.aux.append(open_counted(
                    t, resident_bytes_per_request, BlockKind.CACHE,
                    "decode_state", f"serving/req{ridx}/state"))
            if scratch_b:
                a.aux.append(open_counted(
                    t, scratch_b, BlockKind.TEMP, "spec_scratch",
                    f"serving/req{ridx}/scratch"))
            return a

        def leave(a: _Active, t: int) -> None:
            for idx in a.pages:
                close_counted(idx, t)
            for idx in a.aux:
                close_counted(idx, t)
            if a.shared:
                release_shared(t, a.shared)

        while waiting or requeued or active:
            if len(blocks) > self.MAX_BLOCKS:
                raise ValueError(
                    f"request stream lowers to more than "
                    f"{self.MAX_BLOCKS} blocks — shrink the stream or "
                    f"raise the page size")
            # 1) departures: requests that finished last tick's decode
            still = []
            for a in active:
                if a.decoded >= a.r.decode_len:
                    leave(a, t)
                else:
                    still.append(a)
            active = still
            # 2) scripted evictions
            still = []
            for a in active:
                if a.r.evict_at is not None and t >= a.r.evict_at \
                        and a.ridx not in evicted_once:
                    evicted_once.add(a.ridx)
                    evicted_tokens[a.ridx] = a.tokens
                    leave(a, t)
                    requeued.append(a.ridx)
                    evictions += 1
                else:
                    still.append(a)
            active = still
            # 3) admissions: re-queued first, then arrivals in order
            while len(active) < k.max_concurrent and (
                    requeued
                    or (waiting and stream.requests[waiting[0]].arrival_t
                        <= t)):
                ridx = (requeued.pop(0) if requeued
                        else waiting.pop(0))
                active.append(join(ridx, t))
            # 4) decode one token per active request
            for a in active:
                a.tokens += 1
                a.decoded += 1
                if a.tokens > (len(a.shared) + len(a.pages)) \
                        * k.page_size:
                    p = len(a.shared) + len(a.pages)
                    a.pages.append(open_counted(
                        t, page_b, BlockKind.CACHE, "kv_page",
                        f"serving/req{a.ridx}/page{p}"))
            occupancy.append(len(active))
            live_paged.append(live_now[0])
            t += 1

        meta = {
            "workload": "request_stream",
            "ticks": t,
            "n_requests": len(stream.requests),
            "evictions": evictions,
            "page_bytes": page_b,
            "kv_bytes_per_token": tok_b,
            "resident_bytes_per_request": int(resident_bytes_per_request),
            "occupancy": occupancy,
            "live_paged": live_paged,
            "knobs": dataclasses.asdict(k),
        }
        return RequestBlocks(blocks, meta)
