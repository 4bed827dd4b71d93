"""The port's copies of the framework-neutral stages against the JAX
package's: the same lifecycles replay to equal ``SimResult``s through
both ``MemorySimulator``s, and schema-v5 dumps load in either package.
"""
import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import allocator as jalloc
from repro.core import events as jev
from repro.core import simulator as jsim
from repro.core.tracer import trace_fn as jax_trace_fn
from repro_torch.core import allocator as talloc
from repro_torch.core import events as tev
from repro_torch.core import simulator as tsim
from repro_torch.core.tracer import trace_fn as torch_trace_fn

POLICIES = ["CUDA_CACHING", "XLA_BFC", "TPU_ARENA"]


def _lifecycles(ev, n=400, seed=0):
    """A random alloc/free stream: mixed small and large blocks,
    overlapping lifetimes, some persistent, mixed kinds."""
    rng = np.random.default_rng(seed)
    kinds = list(ev.BlockKind)
    out = []
    for bid in range(n):
        big = rng.random() < 0.2
        size = int(rng.integers(1 << 20, 64 << 20) if big
                   else rng.integers(1, 1 << 20))
        at = 2 * bid
        life = int(rng.integers(1, 120))
        ft = None if rng.random() < 0.1 else at + 2 * life + 1
        out.append(ev.BlockLifecycle(
            bid, size, at, ft, 0, ev.Phase.FORWARD_BACKWARD, "op", "",
            kinds[int(rng.integers(len(kinds)))], 1.0, (size,)))
    return out


@pytest.mark.parametrize("engine", ["object", "columnar"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("capacity", [1 << 62, 512 << 20],
                         ids=["unbounded", "oom_at_512MiB"])
def test_simresults_equal(policy, engine, capacity):
    res = []
    for sim_mod, alloc_mod, ev in ((jsim, jalloc, jev),
                                   (tsim, talloc, tev)):
        sim = sim_mod.MemorySimulator(getattr(alloc_mod, policy), capacity,
                                      engine=engine)
        res.append(dataclasses.asdict(sim.replay(_lifecycles(ev))))
    assert res[0] == res[1]
    assert res[0]["oom"] == (capacity < (1 << 62))


def _jax_trace():
    def step(w, x):
        h = jnp.tanh(x @ w)
        return (h * 2.0) @ w.T
    trace, _ = jax_trace_fn(step, jnp.zeros((64, 32)), jnp.zeros((8, 64)))
    return trace


def _torch_trace():
    import torch

    def step(w, x):
        h = torch.tanh(x @ w)
        return (h * 2.0) @ w.T
    trace, _, _ = torch_trace_fn(step, torch.zeros(64, 32),
                                 torch.zeros(8, 64))
    return trace


def _same_columns(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert list(x) == list(y), f.name


@pytest.mark.parametrize("columnar", [True, False])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_trace_dump_round_trips(tmp_path, direction, columnar):
    if direction == "jax_to_torch":
        trace, loader = _jax_trace(), tev.Trace
    else:
        trace, loader = _torch_trace(), jev.Trace
    path = str(tmp_path / "trace.json")
    trace.save(path, columnar=columnar)
    back = loader.load(path)
    assert back.num_iterations == trace.num_iterations
    assert [e.to_json() for e in back.events] == \
        [e.to_json() for e in trace.events]
    if columnar:
        _same_columns(trace.columnar(), back.columnar())


def _plain(block) -> tuple:
    """A lifecycle's fields with each package's enums as their values."""
    return tuple(x.value if isinstance(x, enum.Enum) else x
                 for x in dataclasses.astuple(block))


def test_columnar_blocks_json_round_trips():
    blocks = _lifecycles(jev, n=50)
    d = jev.ColumnarBlocks.from_lifecycles(blocks).to_json()
    port = tev.ColumnarBlocks.from_json(d)
    assert port.to_json() == d
    assert [_plain(b) for b in port.to_lifecycles()] == \
        [_plain(b) for b in blocks]


def test_schema_version_is_shared():
    assert tev.TRACE_SCHEMA_VERSION == jev.TRACE_SCHEMA_VERSION == 5
