"""Memory Simulator — final stage of the xMem pipeline (paper §3.4).

Replays the orchestrated block lifecycles chronologically through the
two-level allocator simulation and reports:

* estimated peak memory (reserved *segments* — the quantity a scheduler
  must budget, paper §2.2.2),
* peak allocated (tensor) bytes — the naive lower bound,
* the full usage curve over time (paper's optional output, used for the
  Fig.-6-style fidelity benchmark),
* OOM verdict for a given capacity — OOM fires only when both simulated
  levels fail after cache reclaim, mirroring the real chain.

Fast-path extensions:

* ``replay`` accepts a ``PeriodicBlocks`` composition and replays the
  repeated middle iterations with **steady-state detection**: once the
  allocator's state fingerprint at two consecutive iteration boundaries
  matches (the paper's §3.1 observation that allocator state stabilizes
  within 2-3 iterations), the remaining identical iterations are skipped
  — their trajectories are provably exact repeats — and replay resumes
  at the final iteration. Replay cost becomes independent of N.
* ``min_feasible_capacity`` computes the smallest device capacity at
  which the job replays without OOM from **one instrumented replay**
  (max over time of in-use segment demand), verifying minimality with
  two bounded replays and falling back to page-granular bisection only
  when the allocator's reclaim behavior genuinely shifts the answer —
  O(1) replays in the common case versus O(capacities) for a sweep of
  ``would_oom`` calls.
"""
from __future__ import annotations

import dataclasses
import heapq
from operator import attrgetter
from typing import Sequence

import numpy as np

from ..obs import spans as obs_spans
from .allocator import (AllocatorPolicy, CachingAllocatorSim, CUDA_CACHING,
                        DeviceAllocatorSim, SimOOMError, default_space_specs,
                        round_size_array, round_up, round_up_array)
from .events import (CYCLE_ID_STRIDE, BlockLifecycle, ComposedBlocks,
                     MemorySpace, PeriodicBlocks, lifecycles_to_events,
                     sharded_sizes_array, shift_cycle_bid, split_cycle_bid)

_UNBOUNDED = 1 << 62

#: Above this many expanded event rows the columnar engine hands back to
#: the object engine, whose steady-state replay is O(cycle) in N while
#: tiled expansion is O(N * cycle).
_MAX_COLUMNAR_EVENTS = 4_000_000


# -- columnar programs (vectorized replay engine) ----------------------------
@dataclasses.dataclass
class ColumnarProgram:
    """A replay-ready, time-sorted columnar event stream.

    Rows are sorted exactly the way the object engine orders its merged
    stream — primary ``t``, frees (kind 0) before allocs (kind 1) at
    equal ``t``, ties broken by block position — so event indices (and
    therefore ``oom_at``) coincide between engines. ``size`` is the
    sharded request size; ``exec_mask`` marks events that actually drive
    the allocator (positive-size allocs, and frees whose alloc both
    executes and precedes them), mirroring the object engine's skip
    rules. A program is immutable and capacity-independent: one build
    serves every probe of a capacity sweep and every point of a batch
    sweep that shares the structure.
    """

    t: np.ndarray          # int64 logical clock
    kind: np.ndarray       # int8: 1 = alloc, 0 = free
    bid: np.ndarray        # int64 block id
    size: np.ndarray       # int64 sharded request bytes
    exec_mask: np.ndarray  # bool: event reaches the allocator
    _n_blocks: int = 0
    _traj: dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return int(self.t.shape[0])

    @property
    def unique_bids(self) -> bool:
        flag = self._traj.get("unique_bids")
        if flag is None:
            allocs = self.bid[self.kind == 1]
            flag = int(np.unique(allocs).shape[0]) == self._n_blocks
            self._traj["unique_bids"] = flag
        return flag

    def arena_trajectory(self, policy: AllocatorPolicy):
        """Capacity-independent arena state curves (live bytes, page
        demand), computed once and cached — every capacity probe of a
        sweep reuses them, so probing K capacities costs one pass plus
        K comparisons."""
        key = (policy.min_block, policy.device_page)
        traj = self._traj.get(key)
        if traj is None:
            exec_mask = self.exec_mask
            exec_alloc = exec_mask & (self.kind == 1)
            rounded = round_size_array(self.size, policy)
            delta = np.where(exec_mask,
                             np.where(self.kind == 1, rounded, -rounded), 0)
            live = np.cumsum(delta)
            want = np.where(exec_alloc,
                            round_up_array(live, policy.device_page), 0)
            traj = self._traj[key] = (exec_alloc, live, want)
        return traj


_BLOCK_COLS = attrgetter("block_id", "size", "alloc_t", "free_t",
                         "shard_factor")


def _block_arrays(blocks: Sequence[BlockLifecycle]):
    n = len(blocks)
    if not n:
        z = np.empty(0, np.int64)
        return z, z, z, z
    bid, size, at, ft, shard = zip(*map(_BLOCK_COLS, blocks))
    bid = np.array(bid, np.int64)
    size = np.array(size, np.int64)
    at = np.array(at, np.int64)
    ft = np.fromiter((-1 if v is None else v for v in ft), np.int64, n)
    shard = np.array(shard, np.float64)
    if np.any(shard != 1.0):
        size = sharded_sizes_array(size, shard)
    return bid, size, at, ft


def _program_from_block_arrays(bid, size, at, ft) -> ColumnarProgram:
    """Expand per-lifecycle columns (free_t == -1 means persistent) into
    the sorted event stream. Row ``i < n_blocks`` is block i's alloc;
    the tail rows are the frees, paired by construction."""
    n_b = int(bid.shape[0])
    idx_f = np.nonzero(ft >= 0)[0]
    n_f = int(idx_f.shape[0])
    n_ev = n_b + n_f

    def expand(col, fill=None):
        out = np.empty(n_ev, col.dtype)
        out[:n_b] = col
        out[n_b:] = col[idx_f] if fill is None else fill
        return out

    ev_t = expand(at, fill=ft[idx_f])
    ev_bid = expand(bid)
    ev_size = expand(size)
    ev_kind = np.zeros(n_ev, np.int8)
    ev_kind[:n_b] = 1
    ev_seq = np.empty(n_ev, np.int64)
    ev_seq[:n_b] = np.arange(n_b)
    ev_seq[n_b:] = idx_f
    order = np.lexsort((ev_seq, ev_kind, ev_t))
    pos = np.empty(n_ev, np.int64)
    pos[order] = np.arange(n_ev)
    alloc_ok = size > 0
    ev_exec = np.empty(n_ev, bool)
    ev_exec[:n_b] = alloc_ok
    ev_exec[n_b:] = alloc_ok[idx_f] & (pos[:n_b][idx_f] < pos[n_b:])
    return ColumnarProgram(ev_t[order], ev_kind[order], ev_bid[order],
                           ev_size[order], ev_exec[order], n_b)


def program_from_lifecycles(blocks: Sequence[BlockLifecycle]
                            ) -> ColumnarProgram:
    return _program_from_block_arrays(*_block_arrays(blocks))


def program_from_periodic(pb: PeriodicBlocks) -> ColumnarProgram:
    """Expand a periodic composition with array arithmetic: the middle
    iterations are offset-shifted tiles of the cycle template (times
    shifted by k*period, ids by the cycle-instance stride) — no
    per-event Python objects are ever built."""
    parts = [_block_arrays(pb.prefix)]
    nc, P = pb.n_cycles, pb.period
    if nc > 0 and len(pb.cycle):
        c_bid, c_size, c_at, c_ft = _block_arrays(pb.cycle)
        C = c_bid.shape[0]
        inst = np.arange(nc, dtype=np.int64)
        dt = (inst * P)[:, None]
        shift = ((inst + 1) * CYCLE_ID_STRIDE)[:, None]
        ft_tiled = np.where(c_ft[None, :] < 0, np.int64(-1),
                            c_ft[None, :] + dt)
        parts.append(((c_bid[None, :] + shift).ravel(),
                      np.broadcast_to(c_size, (nc, C)).ravel(),
                      (c_at[None, :] + dt).ravel(),
                      ft_tiled.ravel()))
    parts.append(_block_arrays(pb.suffix))
    bid, size, at, ft = (np.concatenate(cols) for cols in zip(*parts))
    return _program_from_block_arrays(bid, size, at, ft)


@dataclasses.dataclass
class SimResult:
    peak_reserved: int            # the estimate a scheduler budgets
    peak_allocated: int           # sum-of-live-tensors peak (naive bound)
    oom: bool
    oom_at: int | None            # event index of OOM, if any
    curve: list[tuple[int, int, int]]   # (t, allocated, reserved)
    stats: dict
    segments: list[dict]          # final segment map (fidelity plots)

    @property
    def fragmentation_overhead(self) -> float:
        if not self.peak_allocated:
            return 0.0
        return self.peak_reserved / self.peak_allocated - 1.0


def split_blocks_by_space(blocks):
    """Partition a flat lifecycle list or ``PeriodicBlocks`` composition
    into per-space sub-compositions (same structure, same times — each
    space's allocator sees only its own demand). Returns a dict keyed by
    :class:`MemorySpace`; inputs that never left the device return a
    single-entry dict holding the *original* object, so the all-device
    replay path is byte-for-byte the one-space case."""
    if isinstance(blocks, PeriodicBlocks):
        spaces = {b.space for part in (blocks.prefix, blocks.cycle,
                                       blocks.suffix) for b in part}
        if spaces <= {MemorySpace.DEVICE_HBM}:
            return {MemorySpace.DEVICE_HBM: blocks}
        out = {}
        for s in spaces:
            out[s] = PeriodicBlocks(
                [b for b in blocks.prefix if b.space is s],
                [b for b in blocks.cycle if b.space is s],
                blocks.n_cycles, blocks.period,
                [b for b in blocks.suffix if b.space is s],
                dict(blocks.meta))
        return out
    if isinstance(blocks, ComposedBlocks):
        # non-periodic composition (e.g. RequestBlocks): all-device
        # inputs keep the ORIGINAL object (single-space replay path is
        # byte-for-byte the composed replay); mixed-space inputs fall
        # through to the flat partition over the materialized stream
        spaces = {b.space for b in blocks.iter_groups()}
        if spaces <= {MemorySpace.DEVICE_HBM}:
            return {MemorySpace.DEVICE_HBM: blocks}
        blocks = blocks.materialize()
    spaces = {b.space for b in blocks}
    if spaces <= {MemorySpace.DEVICE_HBM}:
        return {MemorySpace.DEVICE_HBM: blocks}
    out = {s: [] for s in spaces}
    for b in blocks:
        out[b.space].append(b)
    return out


def _event_tuples(blocks: Sequence[BlockLifecycle], seq0: int
                  ) -> list[tuple[int, int, int, int, int, int]]:
    """(t, order, seq, kind, block_id, size) tuples, sorted the same way
    ``lifecycles_to_events`` sorts: frees before allocs at equal t, ties
    broken by block position (``seq``) — the order the allocator sees."""
    evs = []
    for i, b in enumerate(blocks):
        s = b.sharded_size
        evs.append((b.alloc_t, 1, seq0 + i, 1, b.block_id, s))
        if b.free_t is not None:
            evs.append((b.free_t, 0, seq0 + i, 0, b.block_id, s))
    evs.sort()
    return evs


class MemorySimulator:
    """Two-level allocator replay with two interchangeable engines.

    ``engine="object"`` (default) is the reference implementation: the
    per-event Python interpreter, including steady-state extrapolation
    for periodic compositions. ``engine="columnar"`` replays a
    :class:`ColumnarProgram` — exact vectorized prefix-sum liveness for
    the arena policy, a batched stepper (numpy rounding + tight loop
    over primitive columns) for the BFC policies — and falls back to the
    object engine whenever a program cannot represent the input (block-id
    collisions, or expansions past ``_MAX_COLUMNAR_EVENTS`` where
    steady-state skipping wins). Both engines produce identical
    ``SimResult`` peaks and OOM points (tests/test_columnar.py).
    """

    def __init__(self, policy: AllocatorPolicy = CUDA_CACHING,
                 capacity: int = _UNBOUNDED, engine: str = "object"):
        if engine not in ("object", "columnar"):
            raise ValueError(f"unknown replay engine {engine!r}")
        self.policy = policy
        self.capacity = capacity
        self.engine = engine
        self.last_capacity_replays = 0    # replays used by the last sweep

    # -- columnar dispatch ----------------------------------------------------
    def as_program(self, blocks) -> ColumnarProgram | None:
        """Build (or pass through) a columnar program, or None when the
        input needs the object engine. A *prebuilt* program that this
        policy cannot replay (arena + colliding block ids) raises — it
        carries no lifecycles to fall back to."""
        if isinstance(blocks, ColumnarProgram):
            if self.policy.arena and not blocks.unique_bids:
                raise ValueError(
                    "ColumnarProgram has colliding block ids: the arena "
                    "engine needs unique lifecycle ids — replay the "
                    "original lifecycles instead (the object engine "
                    "resolves collisions through its handle table)")
            return blocks
        if isinstance(blocks, PeriodicBlocks):
            rows = 2 * (len(blocks.prefix) + len(blocks.suffix)
                        + blocks.n_cycles * len(blocks.cycle))
            if rows > _MAX_COLUMNAR_EVENTS:
                return None
            prog = program_from_periodic(blocks)
        else:
            if isinstance(blocks, ComposedBlocks):
                blocks = blocks.materialize()
            if 2 * len(blocks) > _MAX_COLUMNAR_EVENTS:
                return None
            prog = program_from_lifecycles(blocks)
        if self.policy.arena and not prog.unique_bids:
            # the vectorized pairing assumes one lifecycle per id; the
            # object engine's handle table resolves collisions instead
            return None
        return prog

    def replay_program(self, prog: ColumnarProgram) -> SimResult:
        if self.policy.arena:
            return self._replay_arena_program(prog)
        return self._replay_bfc_program(prog)

    def replay(self, blocks, steady_state: bool = True) -> SimResult:
        """Replay a flat lifecycle list, a ``PeriodicBlocks`` composition
        or a prebuilt ``ColumnarProgram``."""
        # replay span — one ContextVar.get when observability
        # is off; the replay itself is untouched either way
        with obs_spans.span("simulator.replay", engine=self.engine):
            if self.engine == "columnar" \
                    or isinstance(blocks, ColumnarProgram):
                prog = self.as_program(blocks)
                if prog is not None:
                    return self.replay_program(prog)
            if isinstance(blocks, PeriodicBlocks):
                return self._replay_periodic(blocks, steady_state)
            if isinstance(blocks, ComposedBlocks):
                blocks = blocks.materialize()
            events = lifecycles_to_events(blocks)
            device = DeviceAllocatorSim(self.capacity,
                                        self.policy.device_page)
            sim = CachingAllocatorSim(self.policy, device)
            handles: dict[int, int] = {}
            oom, oom_at = False, None
            for i, e in enumerate(events):
                try:
                    if e.kind == "alloc":
                        if e.size <= 0:
                            continue
                        handles[e.block_id] = sim.malloc(e.size, t=e.t)
                    else:
                        h = handles.pop(e.block_id, None)
                        if h is not None:
                            sim.free(h, t=e.t)
                except SimOOMError:
                    oom, oom_at = True, i
                    break
            return self._result(sim, oom, oom_at)

    @staticmethod
    def _result(sim: CachingAllocatorSim, oom: bool, oom_at,
                extra_stats: dict | None = None) -> SimResult:
        stats = sim.stats()
        if extra_stats:
            stats.update(extra_stats)
        return SimResult(
            peak_reserved=sim.peak_reserved,
            peak_allocated=sim.peak_allocated,
            oom=oom,
            oom_at=oom_at,
            curve=sim.timeline,
            stats=stats,
            segments=sim.segments_snapshot(),
        )

    def _replay_event_tuples(self, evs, nc: int) -> SimResult:
        """Linear replay of pre-merged (t, order, seq, kind, bid, size)
        tuples — the small-N fast path (no heap, no boundary tracking)."""
        device = DeviceAllocatorSim(self.capacity, self.policy.device_page)
        sim = CachingAllocatorSim(self.policy, device)
        handles: dict[int, int] = {}
        oom, oom_at = False, None
        n_done = 0
        try:
            for t, _o, _s, kind, bid, size in evs:
                if kind == 1:
                    if size > 0:
                        handles[bid] = sim.malloc(size, t=t)
                else:
                    h = handles.pop(bid, None)
                    if h is not None:
                        sim.free(h, t=t)
                n_done += 1
        except SimOOMError:
            oom, oom_at = True, n_done
        return self._result(sim, oom, oom_at, extra_stats={
            "steady_state": {"cycles_total": nc, "cycles_skipped": 0,
                             "detected_at": None, "period": None},
            "events_replayed": n_done,
        })

    # -- periodic replay with steady-state extrapolation ---------------------
    def _replay_periodic(self, pb: PeriodicBlocks,
                         steady_state: bool = True) -> SimResult:
        P, nc = pb.period, pb.n_cycles
        base = _event_tuples(pb.cycle, seq0=len(pb.prefix))
        cycle_start = pb.meta.get("cycle_start")
        # Steady-state bookkeeping is only sound when each cycle instance's
        # events stay within two periods of its window start (alloc in its
        # own window, frees at most one full window ahead — at_next_iter
        # gradients and next-iteration output release land exactly on the
        # +2P boundary). Compositions violating that replay fully.
        span_ok = (nc > 0 and cycle_start is not None and P > 0
                   and (not base or base[-1][0] <= cycle_start + 2 * P))
        if nc > 1 and not span_ok:
            return self.replay(pb.materialize(), steady_state=False)

        prefix_ev = _event_tuples(pb.prefix, seq0=0)
        suffix_ev = _event_tuples(
            pb.suffix, seq0=len(pb.prefix) + nc * len(pb.cycle))
        if nc < 3 or not steady_state:
            # too few cycles for a skip to ever pay off (detection needs
            # two boundary fingerprints plus at least one window to
            # jump): replay the fully merged stream without the heap
            evs = list(prefix_ev)
            C = len(pb.cycle)
            for k in range(nc):
                dt, ds = k * P, k * C
                evs.extend((t + dt, o, s + ds, kind,
                            shift_cycle_bid(bid, k), size)
                           for t, o, s, kind, bid, size in base)
            evs.extend(suffix_ev)
            evs.sort()
            return self._replay_event_tuples(evs, nc)
        device = DeviceAllocatorSim(self.capacity, self.policy.device_page)
        sim = CachingAllocatorSim(self.policy, device)
        handles: dict[int, int] = {}
        oom, oom_at = False, None
        n_done = 0

        # heap entries: (t, order, seq, src, idx, inst) where src is one of
        # "p"(refix), "c"(ycle instance), "s"(uffix)
        heap: list = []

        def push(src: str, idx: int, inst: int = 0) -> None:
            if src == "p":
                if idx >= len(prefix_ev):
                    return
                t, order, seq, *_ = prefix_ev[idx]
            elif src == "s":
                if idx >= len(suffix_ev):
                    return
                t, order, seq, *_ = suffix_ev[idx]
            else:
                if idx >= len(base):
                    return
                t, order, seq, *_ = base[idx]
                t += inst * P
                seq += inst * len(pb.cycle)
            heapq.heappush(heap, (t, order, seq, src, idx, inst))

        def payload(src: str, idx: int, inst: int) -> tuple[int, int, int, int]:
            if src == "p":
                t, _, _, kind, bid, size = prefix_ev[idx]
            elif src == "s":
                t, _, _, kind, bid, size = suffix_ev[idx]
            else:
                t, _, _, kind, bid, size = base[idx]
                t += inst * P
                bid = shift_cycle_bid(bid, inst)
            return t, kind, bid, size

        push("p", 0)
        push("s", 0)
        if nc > 0:
            push("c", 0, 0)
        activated = 1 if nc > 0 else 0   # cycle instances with events pushed
        prefix_left = len(prefix_ev)     # prefix events not yet processed

        def handle_pattern(boundary: int) -> int:
            """Live-handle structure relative to the boundary index —
            must repeat (with the instance index rebased) for the future
            event stream to act on an isomorphic state."""
            pat = []
            for bid in handles:
                inst, raw = split_cycle_bid(bid)
                if inst >= 0:
                    pat.append((1, boundary - inst, raw))
                else:
                    pat.append((0, 0, bid))
            pat.sort()
            return hash(tuple(pat))

        jb = 1                              # next boundary index to observe
        next_boundary = (cycle_start + P) if span_ok else None
        fp_hist: list = []                  # fingerprints at B_1..B_{jb-1}
        max_period = 4                      # e.g. at_next_iter grads double-
        detected_at = None                  # buffer -> state period 2
        skipped_cycles = 0
        ss_period = None

        def first_base_at(t_cut: int) -> int:
            i = 0
            while i < len(base) and base[i][0] < t_cut:
                i += 1
            return i

        while heap:
            t_min = heap[0][0]
            # boundary bookkeeping: fingerprint when replay first reaches
            # each cycle-window start B_j = cycle_start + j*P
            skip_done = False
            while (next_boundary is not None and t_min >= next_boundary
                   and jb <= nc):
                fp = (sim.state_fingerprint(), handle_pattern(jb))
                p_found = None
                for p in range(1, min(max_period, len(fp_hist)) + 1):
                    if fp_hist[-p] == fp:
                        p_found = p
                        break
                m = ((nc - jb) // p_found) * p_found if p_found else 0
                if steady_state and m > 0 and prefix_left == 0:
                    # the state cycles with period p: windows jb..jb+m-1
                    # are exact repeats — jump m windows ahead with the
                    # live cycle handles rebased by m instances, then
                    # replay the < p remaining windows + tail + suffix.
                    jp = jb + m
                    remapped: dict[int, int] = {}
                    for bid, h in handles.items():
                        inst, raw = split_cycle_bid(bid)
                        if inst >= 0:
                            bid = shift_cycle_bid(raw, inst + m)
                        remapped[bid] = h
                    handles = remapped
                    heap = []
                    # instances jp-2 / jp-1 contribute their events from
                    # B_jp onward (span <= 2 periods, checked above)
                    for back in (2, 1):
                        inst = jp - back
                        if 0 <= inst < nc:
                            push("c",
                                 first_base_at(cycle_start + back * P), inst)
                    if jp < nc:
                        push("c", 0, jp)
                        activated = jp + 1
                    else:
                        activated = nc
                    push("s", 0)
                    detected_at = jb
                    skipped_cycles = m
                    ss_period = p_found
                    next_boundary = None
                    skip_done = True
                    break
                fp_hist.append(fp)
                jb += 1
                next_boundary = (cycle_start + jb * P) if jb <= nc else None
            if skip_done:
                continue                  # stream rebuilt; re-enter loop
            _, _, _, src, idx, inst = heapq.heappop(heap)
            if src == "p":
                prefix_left -= 1
                push("p", idx + 1)
            elif src == "s":
                push("s", idx + 1)
            else:
                push("c", idx + 1, inst)
                if idx == 0 and inst + 1 < nc and activated == inst + 1:
                    push("c", 0, inst + 1)    # activate the next instance
                    activated += 1
            t, kind, bid, size = payload(src, idx, inst)
            try:
                if kind == 1:
                    if size > 0:
                        handles[bid] = sim.malloc(size, t=t)
                else:
                    h = handles.pop(bid, None)
                    if h is not None:
                        sim.free(h, t=t)
            except SimOOMError:
                oom, oom_at = True, n_done
                break
            n_done += 1
        return self._result(sim, oom, oom_at, extra_stats={
            "steady_state": {
                "cycles_total": nc,
                "cycles_skipped": skipped_cycles,
                "detected_at": detected_at,
                "period": ss_period,
            },
            "events_replayed": n_done,
        })

    # -- columnar engines ------------------------------------------------------
    def _replay_arena_program(self, prog: ColumnarProgram) -> SimResult:
        """Exact vectorized arena replay: request rounding, live-byte
        prefix sum, page-rounded demand curve and first-over-capacity OOM
        detection are all single array expressions. O(n log n) in the
        event count (the sort lives in program construction)."""
        n = len(prog)
        # arena demand: reserved ratchets to round_up(live, page) at each
        # executing alloc; OOM iff that want exceeds capacity (§3.4(v)
        # collapses to one comparison — reclaim cannot help a compacting
        # arena whose live bytes alone overflow). The curves are
        # capacity-independent, so they are cached on the program and
        # every capacity probe pays only the comparisons below.
        exec_alloc, live, want = prog.arena_trajectory(self.policy)
        over = want > self.capacity
        oom = bool(over.any())
        oom_at = int(np.argmax(over)) if oom else None
        j = oom_at if oom else n
        live_j, want_j = live[:j], want[:j]
        alloc_j = exec_alloc[:j]
        peak_alloc = int(live_j[alloc_j].max()) if alloc_j.any() else 0
        res_run = np.maximum.accumulate(want_j)
        reserved = int(res_run[-1]) if j else 0
        demand_hi = j + 1 if oom else n   # failing want still recorded
        max_inuse = int(want[:demand_hi].max()) if demand_hi else 0
        executed = prog.exec_mask[:j]
        curve = list(zip(prog.t[:j][executed].tolist(),
                         live_j[executed].tolist(),
                         res_run[executed].tolist()))
        allocated = int(live_j[-1]) if j else 0
        stats = {
            "allocated": allocated,
            "reserved": reserved,
            "peak_allocated": peak_alloc,
            "peak_reserved": reserved,
            "device_peak_reserved": reserved,
            "n_splits": 0, "n_merges": 0, "n_cache_hits": 0,
            "n_segments": 0,
            "max_inuse_demand": max_inuse,
            "engine": "columnar",
            "events_replayed": j,
        }
        return SimResult(peak_reserved=reserved, peak_allocated=peak_alloc,
                         oom=oom, oom_at=oom_at, curve=curve, stats=stats,
                         segments=[])

    def _replay_bfc_program(self, prog: ColumnarProgram) -> SimResult:
        """Batched BFC stepper: request rounding is done for the whole
        column with numpy and events stream through a tight loop over
        primitive values; the Python free-list/segment logic is entered
        only where BFC state actually decides (best-fit, split, coalesce,
        reclaim)."""
        device = DeviceAllocatorSim(self.capacity, self.policy.device_page)
        sim = CachingAllocatorSim(self.policy, device)
        rounded = round_size_array(prog.size, self.policy)
        handles: dict[int, int] = {}
        malloc = sim.malloc_rounded
        free = sim.free
        pop = handles.pop
        oom, oom_at = False, None
        n_done = 0
        try:
            for kind, bid, rsize, size, t in zip(
                    prog.kind.tolist(), prog.bid.tolist(), rounded.tolist(),
                    prog.size.tolist(), prog.t.tolist()):
                if kind:
                    if size > 0:
                        handles[bid] = malloc(rsize, t)
                else:
                    h = pop(bid, None)
                    if h is not None:
                        free(h, t)
                n_done += 1
        except SimOOMError:
            oom, oom_at = True, n_done
        return self._result(sim, oom, oom_at, extra_stats={
            "engine": "columnar", "events_replayed": n_done})

    # -- multi-space replay ----------------------------------------------------
    def replay_spaces(self, blocks, space_specs: dict | None = None,
                      steady_state: bool = True) -> SimResult:
        """Replay a (possibly multi-space) composition and report
        per-space peaks.

        Each space's demand replays independently through that space's
        own allocator policy (device HBM pages vs pinned-arena vs
        malloc-like pageable — per ``space_specs``, defaulting to
        :func:`default_space_specs` with this simulator's device policy
        and capacity). The primary :class:`SimResult` is the *device*
        replay — the quantity schedulers budget — and
        ``stats["space_peaks"]`` maps space name to peak reserved bytes;
        ``stats["host_spaces"]`` carries each host space's peaks and OOM
        verdict (against its capacity, unbounded by default), and
        ``stats["any_space_oom"]`` is the job-level verdict.

        All-device inputs take exactly the single-space :meth:`replay`
        path on the original object — bit-identical to the pre-v4
        engine by construction.
        """
        groups = split_blocks_by_space(blocks) \
            if not isinstance(blocks, ColumnarProgram) \
            else {MemorySpace.DEVICE_HBM: blocks}
        host_spaces = [s for s in groups if s is not MemorySpace.DEVICE_HBM]
        if not host_spaces:
            res = self.replay(blocks, steady_state)
            res.stats["space_peaks"] = {
                MemorySpace.DEVICE_HBM.value: res.peak_reserved}
            return res
        specs = space_specs if space_specs is not None else \
            default_space_specs(
                self.policy,
                None if self.capacity >= _UNBOUNDED else self.capacity)
        dev = groups.get(MemorySpace.DEVICE_HBM)
        if dev is None:
            dev = []
        res = self.replay(dev, steady_state)
        peaks = {MemorySpace.DEVICE_HBM.value: res.peak_reserved}
        host_stats: dict[str, dict] = {}
        any_oom = res.oom
        for s in host_spaces:
            spec = specs.get(s)
            policy = spec.policy if spec is not None else self.policy
            cap = (spec.capacity if spec is not None
                   and spec.capacity is not None else _UNBOUNDED)
            sub = MemorySimulator(policy, cap, self.engine).replay(
                groups[s], steady_state)
            peaks[s.value] = sub.peak_reserved
            host_stats[s.value] = {
                "peak_reserved": sub.peak_reserved,
                "peak_allocated": sub.peak_allocated,
                "oom": sub.oom,
                "policy": policy.name,
            }
            any_oom = any_oom or sub.oom
        res.stats["space_peaks"] = peaks
        res.stats["host_spaces"] = host_stats
        res.stats["any_space_oom"] = any_oom
        return res

    # -- capacity probing ------------------------------------------------------
    def would_oom(self, blocks, capacity: int) -> bool:
        """Two-level OOM verdict at a specific capacity (PEF round 2)."""
        return MemorySimulator(self.policy, capacity,
                               self.engine).replay(blocks).oom

    def min_feasible_capacity(self, blocks,
                              probe: SimResult | None = None) -> int:
        """Smallest capacity at which ``blocks`` replays without OOM.

        One instrumented unbounded replay yields the max in-use segment
        demand (the candidate) plus a proven bracket: ``peak_allocated``
        rounded up is a hard lower bound, and an unbounded run's
        ``peak_reserved`` is always feasible (the trajectory is identical
        at that capacity).

        For the arena policy the candidate is returned outright — an
        arena trajectory is capacity-independent up to its OOM point, so
        feasibility at c is exactly ``max demand <= c`` and the
        instrumented maximum IS the answer (a true multi-capacity replay:
        every candidate capacity is decided by the one demand curve).
        For the BFC policies reclaim can genuinely shift the answer, so
        two verification replays confirm the candidate and a
        page-granular bisection resolves divergence; with the columnar
        engine all of those probes share one prebuilt program (the sort
        and rounding are paid once, not per probe).
        """
        page = max(self.policy.device_page, 1)
        prog = (self.as_program(blocks) if self.engine == "columnar"
                else None)

        def replay_at(cap: int) -> SimResult:
            sim = MemorySimulator(self.policy, cap, self.engine)
            return (sim.replay_program(prog) if prog is not None
                    else sim.replay(blocks))

        # a usable probe must be a COMPLETE unbounded replay: an OOM'd or
        # capacity-constrained run has truncated peaks/demand (and its
        # reclaim behavior invalidates the feasible-by-identity bracket)
        if (probe is None or probe.oom
                or "max_inuse_demand" not in probe.stats):
            probe = replay_at(_UNBOUNDED)
            self.last_capacity_replays = 1
        else:
            self.last_capacity_replays = 0
        if probe.peak_reserved <= 0:
            return 0
        lo = round_up(max(probe.peak_allocated, 1), page)
        cand = max(round_up(
            probe.stats.get("max_inuse_demand", probe.peak_reserved),
            page), lo)
        if self.policy.arena:
            return cand                     # exact, zero extra replays

        def feasible(c: int) -> bool:
            self.last_capacity_replays += 1
            return not replay_at(c).oom

        # upper bracket: an unbounded run's peak_reserved is usually
        # feasible by trajectory identity, but growth-doubling policies
        # can need MORE than the unbounded reservation once capacity
        # pressure reorders reclaims and doubling grants — so the
        # bracket is verified and grown geometrically until it holds
        hi = max(round_up(probe.peak_reserved, page), cand)
        while not feasible(hi):
            hi = round_up(hi * 2, page)
        cand = min(cand, hi)

        lo_k, hi_k = lo // page, hi // page
        if cand == hi or feasible(cand):
            if cand <= lo or not feasible(cand - page):
                return cand                            # O(1) replays
            hi_k = cand // page - 1
        else:
            lo_k = cand // page + 1
        while lo_k < hi_k:
            mid = (lo_k + hi_k) // 2
            if feasible(mid * page):
                hi_k = mid
            else:
                lo_k = mid + 1
        return hi_k * page
