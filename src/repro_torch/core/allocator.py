"""Two-level memory-allocator simulation (paper §3.4 + released artifact).

Level 1 — the *framework* caching allocator. Default policy is a faithful
Python port of PyTorch's ``CUDACachingAllocator`` (c10/cuda, release/2.6):
512-byte rounding, small/large pools with 2 MiB / 20 MiB segments,
best-fit-with-coalescing (BFC), block splitting, segment caching, and the
reclaim-before-OOM ladder. Two further policies adapt the simulation to
the XLA world (DESIGN.md §2): ``XLA_BFC`` (TF/XLA GPU BFC: 256-byte
rounding, single pool, doubling region growth) and ``TPU_ARENA`` (TPU
runtime: compacting arena — per-program static assignment means external
fragmentation is resolved at compile time, so reserved ≈ rounded live).

Level 2 — the *device* allocator: grants whole segments against an HBM
capacity with its own page granularity. An OOM is signalled only when a
request fails at L1, L1 reclaims its cached segments, and the L2 grant
still fails — the complete chain the paper identifies as the true OOM
condition (§3.4(v)), which simpler simulators (DNNMem) omit.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import Optional

import numpy as np

KiB = 1024
MiB = 1024 * 1024


class SimOOMError(Exception):
    """Raised when both allocator levels fail, post-reclaim (paper §3.4(v))."""

    def __init__(self, requested: int, reserved: int, capacity: int):
        self.requested, self.reserved, self.capacity = requested, reserved, capacity
        super().__init__(
            f"simulated OOM: request {requested} B with {reserved} B reserved "
            f"of {capacity} B capacity (after cache reclaim)"
        )


@dataclasses.dataclass(frozen=True)
class AllocatorPolicy:
    """Constants defining one framework-allocator behavior."""

    name: str
    min_block: int            # block-size rounding quantum
    small_size: int           # requests <= this use the small pool
    small_buffer: int         # segment size for small-pool requests
    large_buffer: int         # segment size for mid-size large requests
    min_large_alloc: int      # requests >= this size their own segment
    round_large: int          # granularity for own-segment sizing
    device_page: int          # L2 grant granularity
    split_remainder_large: int  # split a large block only if remainder > this
    single_pool: bool = False   # XLA BFC has no small/large split
    growth_doubling: bool = False  # XLA BFC grows regions by doubling
    arena: bool = False         # TPU arena: compacting, no external frag


# PyTorch CUDACachingAllocator constants (c10/cuda/CUDACachingAllocator.cpp).
CUDA_CACHING = AllocatorPolicy(
    name="cuda_caching", min_block=512, small_size=1 * MiB,
    small_buffer=2 * MiB, large_buffer=20 * MiB, min_large_alloc=10 * MiB,
    round_large=2 * MiB, device_page=2 * MiB, split_remainder_large=1 * MiB,
)

# TF/XLA GPU BFC allocator: 256-byte alignment, one pool, doubling regions.
XLA_BFC = AllocatorPolicy(
    name="xla_bfc", min_block=256, small_size=0,
    small_buffer=1 * MiB, large_buffer=1 * MiB, min_large_alloc=1 * MiB,
    round_large=1 * MiB, device_page=2 * MiB, split_remainder_large=256,
    single_pool=True, growth_doubling=True,
)

# TPU runtime arena: compile-time buffer assignment compacts temps, so the
# reserved footprint tracks rounded live bytes (512-byte lane alignment).
TPU_ARENA = AllocatorPolicy(
    name="tpu_arena", min_block=512, small_size=0,
    small_buffer=1 * MiB, large_buffer=1 * MiB, min_large_alloc=0,
    round_large=4 * KiB, device_page=4 * KiB, split_remainder_large=512,
    single_pool=True, arena=True,
)

# Host-side policies for the multi-space model. Pinned host
# memory is page-locked (cudaHostAlloc / TPU pinned pools): 4 KiB pages,
# arena semantics — a pinned pool never externally fragments in the way
# a device BFC does, so reserved tracks rounded live. Pageable host
# memory is plain malloc: 64-byte rounding, same arena accounting.
HOST_PINNED_ARENA = AllocatorPolicy(
    name="host_pinned", min_block=4 * KiB, small_size=0,
    small_buffer=1 * MiB, large_buffer=1 * MiB, min_large_alloc=0,
    round_large=4 * KiB, device_page=4 * KiB, split_remainder_large=4 * KiB,
    single_pool=True, arena=True,
)

HOST_PAGEABLE_MALLOC = AllocatorPolicy(
    name="host_pageable", min_block=64, small_size=0,
    small_buffer=1 * MiB, large_buffer=1 * MiB, min_large_alloc=0,
    round_large=4 * KiB, device_page=4 * KiB, split_remainder_large=64,
    single_pool=True, arena=True,
)

POLICIES = {p.name: p for p in (CUDA_CACHING, XLA_BFC, TPU_ARENA,
                                HOST_PINNED_ARENA, HOST_PAGEABLE_MALLOC)}


@dataclasses.dataclass(frozen=True)
class MemorySpaceSpec:
    """Per-space allocator configuration: which policy models the space
    and how much capacity it has (``None`` = unbounded — host RAM is
    effectively unbounded relative to HBM for estimation purposes)."""

    space: "object"                    # events.MemorySpace (no import cycle)
    policy: AllocatorPolicy
    capacity: int | None = None

    @property
    def bounded(self) -> bool:
        return self.capacity is not None


def default_space_specs(device_policy: AllocatorPolicy,
                        device_capacity: int | None = None,
                        host_pinned_capacity: int | None = None,
                        host_pageable_capacity: int | None = None) -> dict:
    """The standard three-space layout: the caller's device policy plus
    arena-modeled host spaces. Returns ``{MemorySpace: MemorySpaceSpec}``
    keyed by every member of :class:`~repro.core.events.MemorySpace`, so
    a replay engine can look any block's space up unconditionally."""
    from .events import MemorySpace
    return {
        MemorySpace.DEVICE_HBM: MemorySpaceSpec(
            MemorySpace.DEVICE_HBM, device_policy, device_capacity),
        MemorySpace.HOST_PINNED: MemorySpaceSpec(
            MemorySpace.HOST_PINNED, HOST_PINNED_ARENA,
            host_pinned_capacity),
        MemorySpace.HOST_PAGEABLE: MemorySpaceSpec(
            MemorySpace.HOST_PAGEABLE, HOST_PAGEABLE_MALLOC,
            host_pageable_capacity),
    }


def round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q if q else x


# -- vectorized size policy (columnar replay engine) -------------------------
def round_up_array(x: np.ndarray, q: int) -> np.ndarray:
    """Elementwise ``round_up`` over an int64 array."""
    if not q:
        return x
    return (x + (q - 1)) // q * q


def round_size_array(sizes: np.ndarray, policy: AllocatorPolicy) -> np.ndarray:
    """Elementwise ``CachingAllocatorSim.round_size`` — request rounding
    for a whole event column in one shot."""
    return np.maximum(round_up_array(sizes, policy.min_block),
                      policy.min_block)


class DeviceAllocatorSim:
    """Level-2 simulator: grants segments against an HBM/VRAM capacity."""

    def __init__(self, capacity: int, page: int):
        self.capacity = capacity
        self.page = page
        self.reserved = 0
        self.peak_reserved = 0
        self.n_grants = 0
        self.n_returns = 0

    def grant(self, size: int) -> bool:
        size = round_up(size, self.page)
        if self.reserved + size > self.capacity:
            return False
        self.reserved += size
        self.peak_reserved = max(self.peak_reserved, self.reserved)
        self.n_grants += 1
        return True

    def release(self, size: int) -> None:
        self.n_returns += 1
        self.reserved -= round_up(size, self.page)


class _Block:
    """A block inside a segment; doubly linked for coalescing."""

    __slots__ = ("uid", "segment", "offset", "size", "requested", "free",
                 "prev", "next")

    def __init__(self, uid, segment, offset, size):
        self.uid = uid
        self.segment = segment
        self.offset = offset
        self.size = size
        self.requested = 0
        self.free = True
        self.prev: Optional[_Block] = None
        self.next: Optional[_Block] = None


class _Segment:
    __slots__ = ("sid", "pool", "size", "head", "live")

    def __init__(self, sid, pool, size, head):
        self.sid, self.pool, self.size, self.head = sid, pool, size, head
        self.live = 0            # in-use blocks inside this segment

    def fully_free(self) -> bool:
        return self.head.free and self.head.next is None


class _FreeIndex:
    """Best-fit index over free blocks: sorted (size, uid) list + map."""

    def __init__(self):
        self._keys: list[tuple[int, int]] = []
        self._blocks: dict[int, _Block] = {}

    def add(self, b: _Block) -> None:
        bisect.insort(self._keys, (b.size, b.uid))
        self._blocks[b.uid] = b

    def remove(self, b: _Block) -> None:
        i = bisect.bisect_left(self._keys, (b.size, b.uid))
        assert i < len(self._keys) and self._keys[i] == (b.size, b.uid)
        del self._keys[i]
        del self._blocks[b.uid]

    def best_fit(self, size: int) -> Optional[_Block]:
        i = bisect.bisect_left(self._keys, (size, -1))
        if i == len(self._keys):
            return None
        return self._blocks[self._keys[i][1]]

    def __len__(self):
        return len(self._keys)


class CachingAllocatorSim:
    """Level-1 framework caching-allocator simulator (BFC).

    The public surface is ``malloc(req) -> handle`` / ``free(handle)`` plus
    statistics, mirroring what the Simulator stage replays events through.
    """

    def __init__(self, policy: AllocatorPolicy, device: DeviceAllocatorSim):
        self.policy = policy
        self.device = device
        self._uid = itertools.count()
        self._sid = itertools.count()
        self._free_small = _FreeIndex()
        self._free_large = _FreeIndex()
        self._segments: dict[int, _Segment] = {}
        self._inuse: dict[int, _Block] = {}
        self._grow_next = policy.small_buffer  # growth_doubling cursor
        # statistics
        self.allocated = 0          # bytes of in-use (rounded) blocks
        self.reserved = 0           # bytes held in segments (cached incl.)
        self.peak_allocated = 0
        self.peak_reserved = 0
        self.n_splits = 0
        self.n_merges = 0
        self.n_cache_hits = 0
        self.timeline: list[tuple[int, int, int]] = []  # (t, allocated, reserved)
        # In-use device demand: bytes of segments holding >= 1 live block,
        # page-rounded as the device sees them. Its running max is the
        # single-replay capacity-sweep instrument (min_feasible_capacity):
        # cached-but-free segments are reclaimable under pressure, so the
        # true device requirement at any instant is the in-use demand.
        self.inuse_demand = 0
        self.max_inuse_demand = 0

    # -- size policy ------------------------------------------------------
    def round_size(self, size: int) -> int:
        return max(round_up(size, self.policy.min_block), self.policy.min_block)

    def _pool_of(self, size: int) -> _FreeIndex:
        if self.policy.single_pool or size > self.policy.small_size:
            return self._free_large
        return self._free_small

    def allocation_size(self, size: int) -> int:
        """Segment size requested from the device for a given block size."""
        p = self.policy
        if p.growth_doubling:
            seg = max(self._grow_next, round_up(size, p.round_large))
            return seg
        if not p.single_pool and size <= p.small_size:
            return p.small_buffer
        if size < p.min_large_alloc:
            return p.large_buffer
        return round_up(size, p.round_large)

    def _should_split(self, block: _Block, size: int) -> bool:
        remaining = block.size - size
        p = self.policy
        if p.single_pool or size <= p.small_size:
            return remaining >= p.min_block
        return remaining > p.split_remainder_large

    # -- segment machinery --------------------------------------------------
    def _new_segment(self, pool_name: str, seg_size: int) -> Optional[_Block]:
        if not self.device.grant(seg_size):
            return None
        sid = next(self._sid)
        blk = _Block(next(self._uid), sid, 0, seg_size)
        self._segments[sid] = _Segment(sid, pool_name, seg_size, blk)
        self.reserved += seg_size
        self.peak_reserved = max(self.peak_reserved, self.reserved)
        if self.policy.growth_doubling:
            # TF BFC (BFCAllocator::Extend): a request larger than the
            # growth cursor doubles the cursor until it covers the
            # request and allocates WITHOUT the post-allocation double
            # (increased_allocation short-circuit); only pool-growth
            # regions served at the cursor size double it for next time.
            if seg_size > self._grow_next:
                g = self._grow_next
                while g < seg_size:
                    g *= 2
                self._grow_next = min(g, 1 << 36)
            else:
                self._grow_next = min(self._grow_next * 2, 1 << 36)
        return blk

    def _release_segment(self, seg: _Segment) -> None:
        idx = self._free_small if seg.pool == "small" else self._free_large
        idx.remove(seg.head)
        self.device.release(seg.size)
        self.reserved -= seg.size
        del self._segments[seg.sid]

    def _release_cached(self, pool: Optional[str], need: int) -> int:
        """Free fully-cached segments (largest first); returns bytes freed.

        The reclaim target is compared in *device pages*: the retry grant
        needs ``round_up(need, device_page)`` bytes of device headroom,
        and each released segment returns ``round_up(seg, device_page)``
        — comparing raw segment bytes against raw ``need`` can stop the
        ladder one segment short of what the page-rounded grant actually
        requires, leaving the retry to fail (and the second rung to dump
        every cached segment) near capacity."""
        page = self.policy.device_page
        cands = [s for s in self._segments.values()
                 if s.fully_free() and (pool is None or s.pool == pool)]
        cands.sort(key=lambda s: -s.size)
        need_pages = round_up(need, page) if need else 0
        freed = 0
        freed_pages = 0
        for s in cands:
            self._release_segment(s)
            freed += s.size
            freed_pages += round_up(s.size, page)
            if need_pages and freed_pages >= need_pages:
                break
        return freed

    # -- public API ---------------------------------------------------------
    def malloc(self, req: int, t: int = 0) -> int:
        if self.policy.arena:
            return self._arena_malloc(req, t)
        return self.malloc_rounded(self.round_size(req), t)

    def malloc_rounded(self, size: int, t: int = 0) -> int:
        """``malloc`` for an already request-rounded size — the batched
        replay stepper rounds whole event columns with numpy up front and
        enters here, skipping the per-event size policy."""
        pool = self._pool_of(size)
        pool_name = "large" if pool is self._free_large else "small"
        block = pool.best_fit(size)
        if block is not None:
            self.n_cache_hits += 1
            pool.remove(block)
        else:
            seg_size = self.allocation_size(size)
            block = self._new_segment(pool_name, seg_size)
            if block is None:
                # L2 refused: reclaim ladder (paper §3.4(v)).
                self._release_cached(pool_name, seg_size)
                block = self._new_segment(pool_name, seg_size)
            if block is None:
                self._release_cached(None, 0)  # release everything cached
                block = self._new_segment(pool_name, seg_size)
            if block is None:
                raise SimOOMError(seg_size, self.device.reserved,
                                  self.device.capacity)
        if self._should_split(block, size):
            self.n_splits += 1
            rest = _Block(next(self._uid), block.segment,
                          block.offset + size, block.size - size)
            rest.prev, rest.next = block, block.next
            if block.next is not None:
                block.next.prev = rest
            block.next = rest
            block.size = size
            pool.add(rest)
        block.free = False
        block.requested = size
        self._inuse[block.uid] = block
        self.allocated += size
        self.peak_allocated = max(self.peak_allocated, self.allocated)
        seg = self._segments[block.segment]
        seg.live += 1
        if seg.live == 1:
            self.inuse_demand += round_up(seg.size, self.policy.device_page)
            if self.inuse_demand > self.max_inuse_demand:
                self.max_inuse_demand = self.inuse_demand
        self.timeline.append((t, self.allocated, self.reserved))
        return block.uid

    def free(self, handle: int, t: int = 0) -> None:
        if self.policy.arena:
            return self._arena_free(handle, t)
        block = self._inuse.pop(handle)
        self.allocated -= block.requested
        block.free = True
        block.requested = 0
        seg = self._segments[block.segment]
        seg.live -= 1
        if seg.live == 0:
            self.inuse_demand -= round_up(seg.size, self.policy.device_page)
        pool = self._free_small if seg.pool == "small" else self._free_large
        # coalesce with free neighbors (BFC merge)
        for nb_attr in ("prev", "next"):
            nb = getattr(block, nb_attr)
            if nb is not None and nb.free:
                pool.remove(nb)
                self.n_merges += 1
                lo, hi = (nb, block) if nb_attr == "prev" else (block, nb)
                lo.size += hi.size
                lo.next = hi.next
                if hi.next is not None:
                    hi.next.prev = lo
                if nb_attr == "prev":
                    block = lo
                if seg.head is hi:
                    seg.head = lo
        if block.offset == 0:
            seg.head = block
        pool.add(block)
        self.timeline.append((t, self.allocated, self.reserved))

    # -- arena mode (TPU) -----------------------------------------------------
    def _arena_malloc(self, req: int, t: int) -> int:
        size = self.round_size(req)
        live = self.allocated + size
        want = round_up(live, self.policy.device_page)
        if want > self.max_inuse_demand:   # arena demand = rounded live bytes
            self.max_inuse_demand = want
        if want > self.reserved:
            if not self.device.grant(want - self.reserved):
                # compaction is implicit; if live itself exceeds capacity -> OOM
                raise SimOOMError(want - self.reserved, self.device.reserved,
                                  self.device.capacity)
            self.reserved = want
            self.peak_reserved = max(self.peak_reserved, self.reserved)
        uid = next(self._uid)
        blk = _Block(uid, -1, 0, size)
        blk.requested = size
        blk.free = False
        self._inuse[uid] = blk
        self.allocated = live
        self.peak_allocated = max(self.peak_allocated, self.allocated)
        self.timeline.append((t, self.allocated, self.reserved))
        return uid

    def _arena_free(self, handle: int, t: int) -> None:
        blk = self._inuse.pop(handle)
        self.allocated -= blk.requested
        # arena shrinks lazily: reserved stays at high-water (runtime keeps it)
        self.timeline.append((t, self.allocated, self.reserved))

    # -- introspection ---------------------------------------------------------
    def segments_snapshot(self) -> list[dict]:
        out = []
        for s in self._segments.values():
            blocks, b = [], s.head
            while b is not None:
                blocks.append({"offset": b.offset, "size": b.size,
                               "free": b.free})
                b = b.next
            out.append({"sid": s.sid, "pool": s.pool, "size": s.size,
                        "blocks": blocks})
        return out

    def state_fingerprint(self) -> int:
        """Order-independent hash of the allocator's *behavioral* state.

        Two moments with equal fingerprints (and isomorphic live-handle
        patterns, which the Simulator checks separately) respond to
        identical future event streams with identical byte trajectories:
        the hash covers live/reserved byte counts, the doubling-growth
        cursor, and the full segment/block structure (sizes, free flags,
        offsets implied by in-segment order) — everything ``malloc`` and
        ``free`` consult. Segment ids are deliberately excluded; they
        only name segments, they never steer placement.
        """
        if self.policy.arena:
            live = tuple(sorted(b.requested for b in self._inuse.values()))
            return hash(("arena", self.allocated, self.reserved, live))
        segs = []
        for s in self._segments.values():
            blocks = []
            b = s.head
            while b is not None:
                blocks.append((b.size, b.free, b.requested))
                b = b.next
            segs.append((s.pool, s.size, tuple(blocks)))
        segs.sort()
        return hash((self.allocated, self.reserved, self._grow_next,
                     tuple(segs)))

    def stats(self) -> dict:
        return {
            "allocated": self.allocated,
            "reserved": self.reserved,
            "peak_allocated": self.peak_allocated,
            "peak_reserved": self.peak_reserved,
            "device_peak_reserved": self.device.peak_reserved,
            "n_splits": self.n_splits,
            "n_merges": self.n_merges,
            "n_cache_hits": self.n_cache_hits,
            "n_segments": len(self._segments),
            "max_inuse_demand": self.max_inuse_demand,
        }
