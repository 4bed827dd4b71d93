"""Cost and collective bytes of rank 0's local program (the port's
counterpart of ``repro.launch.hlo_analysis``'s ``cost_analysis_of`` and
``collective_bytes``).

XLA reports a compiled program's FLOPs and bytes and prints its HLO,
whose collectives the reference parses. An eager sharded step has no
compiled program: :class:`ProgramCounter` watches the ops rank 0 runs on
its local shards (a ``TorchDispatchMode`` that hands every op with a
DTensor argument back to DTensor, as the memory tracer does, and skips
DTensor's sharding-propagation ops at global shapes):

* ``flops``: ``torch.utils.flop_counter``'s formula for each local op
  that has one (matmuls; ``bmm``, the attention's einsums and a MoE
  rank's expert products over its own experts' capacity rows), and the
  attention kernel's ``4 d`` per attended (query, key) pair and head;
  ``flops_by_op`` splits them by op (``aten::mm``, ``aten::bmm``,
  ``repro_torch::flash_attention``);
* ``bytes_accessed``: each op's tensor inputs read once and outputs
  written once (views and waits move nothing);
* collectives: each ``_c10d_functional`` (or ``_dtensor``) collective's
  bytes, the larger
  of its operands and its result (an all-gather's gathered tensor, a
  reduce-scatter's whole input, an all-reduce's tensor), by the
  reference's kinds (``all-gather``, ``reduce-scatter``, ``all-reduce``,
  ``all-to-all``, ``collective-permute``), with counts and
  ``total_bytes`` (a MoE layer's combine is one f32 ``all-reduce``
  over the expert axis: expert parallelism here moves no tokens; an
  ``all-to-all`` is DTensor's ``_dtensor::shard_dim_alltoall``, a shard
  moved to another tensor dim, as the card runs it: the expert stacks'
  gradients into their optimizer state's layout);
* ``ops``: the local ops counted (the record's ``hlo_ops``).

Under a ``fake`` process group the collectives move no data: their
bytes are what a real group would move from this rank.
"""
from __future__ import annotations

from collections import Counter

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# ``_c10d_functional`` op -> the reference's collective kind
_KINDS = {"all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all",
          "broadcast": "collective-permute"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def attended_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs a causal or windowed mask keeps, positions of
    both starting at 0 (the attention kernel's masks)."""
    total = 0
    for q in range(sq):
        hi = min(q + 1, sk) if causal else sk
        lo = max(0, q - window + 1) if window else 0
        total += max(hi - lo, 0)
    return total


def _flash_flops(q, k, v, causal, window, scale=None) -> int:
    B, H, Sq, d = q.shape
    return 4 * B * H * d * attended_pairs(Sq, k.shape[2], causal, window)


class ProgramCounter(TorchDispatchMode):
    """Counts the local ops run under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from ..core.tracer import _propagating, _watch_dtensor
        self._registry = flop_registry
        self._propagating = _propagating
        self._dtensor = _watch_dtensor()
        self.flops = 0
        self.flops_by_op = Counter()
        self.bytes_accessed = 0
        self.ops = 0
        self.coll_bytes = Counter({c: 0 for c in COLLECTIVES})
        self.coll_count = Counter({c: 0 for c in COLLECTIVES})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._dtensor and not self._dtensor.isdisjoint(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating():
            return out
        name = func._schema.name
        if name == "prim::device" or name.startswith("prim::"):
            return out
        self.ops += 1
        ns, _, op = name.partition("::")
        if ns in ("_c10d_functional", "_dtensor"):
            kind = _KINDS.get(op)
            if kind is not None:
                self.coll_bytes[kind] += max(
                    sum(_nbytes(t) for t in pytree.tree_leaves(x)
                        if isinstance(t, torch.Tensor)) for x in (args, out))
                self.coll_count[kind] += 1
            return out
        flops = 0
        if name == "repro_torch::flash_attention":
            flops = _flash_flops(*args, **kwargs)
        else:
            f = self._registry.get(func._overloadpacket)
            if f is not None:
                flops = int(f(*args, **kwargs, out_val=out))
        if flops:
            self.flops += flops
            self.flops_by_op[name] += flops
        if not getattr(func, "is_view", False):
            self.bytes_accessed += sum(
                _nbytes(t) for t in pytree.tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out

    def collectives(self) -> dict:
        """The reference's ``collective_bytes`` record: bytes and counts
        by kind, and ``total_bytes``."""
        return {"bytes": dict(self.coll_bytes),
                "count": dict(self.coll_count),
                "total_bytes": int(sum(self.coll_bytes.values()))}

    def cost(self) -> dict:
        """The record's ``cost`` counts (the reference's ``flops`` and
        ``bytes accessed``), and the FLOPs by op."""
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "flops_by_op": {k: float(v)
                                for k, v in sorted(self.flops_by_op.items())}}

    def __add__(self, other: "ProgramCounter") -> "ProgramCounter":
        """The counts of two programs run one after the other."""
        out = ProgramCounter.__new__(ProgramCounter)
        out.flops = self.flops + other.flops
        out.flops_by_op = self.flops_by_op + other.flops_by_op
        out.bytes_accessed = self.bytes_accessed + other.bytes_accessed
        out.ops = self.ops + other.ops
        out.coll_bytes = Counter({c: self.coll_bytes[c] + other.coll_bytes[c]
                                  for c in COLLECTIVES})
        out.coll_count = Counter({c: self.coll_count[c] + other.coll_count[c]
                                  for c in COLLECTIVES})
        return out

    def scaled(self, other: "ProgramCounter", units: int,
               base_units: int) -> "ProgramCounter":
        """Counts at ``units`` repeating units from this count (at
        ``base_units``) and ``other``'s (at ``base_units + 1``): each unit
        adds the same ops, so the count is affine in the units."""
        n = units - base_units
        out = ProgramCounter.__new__(ProgramCounter)
        out.flops = self.flops + n * (other.flops - self.flops)
        out.flops_by_op = Counter({
            k: self.flops_by_op[k] + n * (other.flops_by_op[k]
                                          - self.flops_by_op[k])
            for k in self.flops_by_op | other.flops_by_op})
        out.bytes_accessed = self.bytes_accessed + n * (
            other.bytes_accessed - self.bytes_accessed)
        out.ops = self.ops + n * (other.ops - self.ops)
        out.coll_bytes = Counter({c: self.coll_bytes[c] + n * (
            other.coll_bytes[c] - self.coll_bytes[c]) for c in COLLECTIVES})
        out.coll_count = Counter({c: self.coll_count[c] + n * (
            other.coll_count[c] - self.coll_count[c]) for c in COLLECTIVES})
        return out


def count_local(fn, *args) -> ProgramCounter:
    """Run ``fn(*args)`` (a program's local function on local trees)
    under a :class:`ProgramCounter`, its arguments made fake tensors of
    their shapes first (nothing is allocated)."""
    counter = ProgramCounter()
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..core.tracer import _fake_like
    mode = FakeTensorMode()
    leaves, spec = pytree.tree_flatten(args)
    with mode:
        fakes = [_fake_like(t) if isinstance(t, torch.Tensor) else t
                 for t in leaves]
    with mode, counter:
        fn(*pytree.tree_unflatten(fakes, spec))
    return counter
