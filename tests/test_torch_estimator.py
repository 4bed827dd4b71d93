"""The port's tracer and serving estimate.

Persistent bytes are held byte-exact against the JAX package's
``for_torch_gpu().estimate_serving`` on the same configs; tensor peaks
differ because the op graphs differ, and are not compared. The port's
decode updates the KV cache in place, so its persistent bytes are the
JAX package's minus exactly one cache copy.
"""
import dataclasses
import resource
import time

import jax
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.core.events import BlockKind as JaxKind
from repro.core.events import Phase as JaxPhase
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.configs import registry as treg
from repro_torch.core.estimator import XMemEstimator
from repro_torch.core.events import BlockKind, Phase
from repro_torch.core.tracer import trace_fn
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM

B, MAX_LEN = 4, 32


def _jax_by_kind(arch, phase):
    cfg = jreg.get_smoke(arch)
    params = JM.abstract_params(cfg)
    cache = jax.eval_shape(lambda: JM.init_cache(cfg, B, MAX_LEN))
    if phase == "decode":
        fn, batch = jserve.make_decode_fn(cfg), jserve.decode_input(cfg, B)
    else:
        fn = jserve.make_prefill_fn(cfg)
        batch = jserve.prompt_specs(cfg, B, MAX_LEN)
    est = JaxEstimator.for_torch_gpu()
    entry = est._trace_phase(
        fn, [(params, JaxKind.PARAM, "params"), (cache, JaxKind.CACHE,
                                                 "cache"),
             (batch, JaxKind.INPUT, "batch")], JaxPhase.DECODE, tag="decode")
    by_kind: dict = {}
    for b in entry.input_blocks:
        by_kind[b.kind.value] = by_kind.get(b.kind.value, 0) + b.size
    report = est.estimate_serving(fn, params, cache, batch)
    return by_kind, report


def _port_report(arch, phase):
    cfg = treg.get_smoke(arch)
    params = TM.abstract_params(cfg)
    cache = TM.init_cache(cfg, B, MAX_LEN, device="meta")
    if phase == "decode":
        fn, batch = tserve.make_decode_fn(cfg), tserve.decode_input(cfg, B)
    else:
        fn = tserve.make_prefill_fn(cfg)
        batch = tserve.prompt_specs(cfg, B, MAX_LEN)
    return XMemEstimator.for_torch_gpu().estimate_serving(fn, params, cache,
                                                          batch)


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-32b", "starcoder2-3b"])
def test_param_and_cache_bytes_match_jax(arch, phase):
    jax_kind, jax_report = _jax_by_kind(arch, phase)
    port = _port_report(arch, phase).breakdown["persistent_by_kind"]
    for kind in ("param", "cache", "input"):
        assert port[kind] == jax_kind[kind], kind
    if phase == "decode":
        # the JAX decode step returns a new cache; the port writes in place
        assert (_port_report(arch, phase).persistent_bytes
                == jax_report.persistent_bytes - jax_kind["cache"])


def _kinds_of_blocks(tracer):
    return [b.kind for b in tracer.blocks.values()]


def test_views_and_in_place_ops_create_no_block():
    def step(params, x):
        wt = params["w"].t()                  # view of the parameter
        w2 = params["w"].transpose(0, 1)[:, :4]
        x.mul_(2.0)                           # in place on the input
        return wt, w2
    trace, tr, _ = trace_fn(step, {"w": torch.zeros(64, 32)},
                            torch.zeros(8, 64),
                            arg_kinds=[BlockKind.PARAM, BlockKind.INPUT])
    assert _kinds_of_blocks(tr) == [BlockKind.PARAM, BlockKind.INPUT]
    assert len(trace.events) == 2 and not tr.output_blocks


def test_temporaries_are_freed_and_outputs_pinned():
    def step(w, x):
        h = torch.tanh(x @ w)                 # [8, 32] temporary
        return (h * 2.0) @ w.T                # [8, 64] output
    trace, tr, out = trace_fn(step, torch.zeros(64, 32), torch.zeros(8, 64))
    life = [b for b in tr.lifecycles() if b.op != "input"]
    assert [b.op for b in life] == ["aten::mm", "aten::tanh", "aten::mul",
                                    "aten::mm"]
    assert all(b.free_t is not None for b in life[:3])   # temporaries
    assert [b.size for b in tr.output_blocks] == [8 * 64 * 4]
    assert tr.output_blocks[0].kind is BlockKind.OUTPUT
    assert tr.output_blocks[0].free_t is None
    assert out.shape == (8, 64)
    kinds = [e.kind for e in trace.events]
    assert kinds.count("alloc") == kinds.count("free") + 3  # 2 in, 1 out


def test_kernel_op_allocates_only_its_output():
    cfg = treg.get_smoke("qwen3-32b")
    flash = dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, impl="flash"))
    params = TM.abstract_params(flash)
    cache = TM.init_cache(flash, B, MAX_LEN, device="meta")
    entry = XMemEstimator.for_torch_gpu()._trace_phase(
        tserve.make_prefill_fn(flash),
        [(params, BlockKind.PARAM, "params"),
         (cache, BlockKind.CACHE, "cache"),
         (tserve.prompt_specs(flash, B, MAX_LEN), BlockKind.INPUT,
          "batch")], Phase.DECODE)
    kernel = [b for b in entry.lifecycles
              if b.op == "repro_torch::flash_attention"]
    assert len(kernel) == flash.n_layers
    out_bytes = B * MAX_LEN * cfg.n_heads * cfg.hd * 2     # bf16, no S x S
    assert all(b.size == out_bytes for b in kernel)


def test_full_width_estimate_is_fast_and_allocates_nothing():
    base = treg.get_config("qwen3-32b")
    cfg = dataclasses.replace(
        base, n_layers=8,
        attention=dataclasses.replace(base.attention, impl="flash"))
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss   # KiB
    t0 = time.perf_counter()
    batch, gate = tserve.pick_batch(cfg, 2048, capacity=80 * 2**30,
                                    candidates=(8,))
    seconds = time.perf_counter() - t0
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) * 1024
    assert batch == 8
    params = gate["prefill"].breakdown["persistent_by_kind"]["param"]
    assert params == sum(t.numel() * t.element_size() for t in
                         torch.utils._pytree.tree_leaves(
                             TM.abstract_params(cfg)))
    assert params > 10 * 2**30           # 10.9 GB of bf16 weights ...
    assert grown < 2 * 2**30             # ... and none of it allocated
    assert gate["prefill"].peak_bytes > gate["decode"].peak_bytes > params
    assert seconds < 60

