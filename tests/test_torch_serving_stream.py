"""The port's request-driven serving estimate against the JAX package.

* The paged half is bit-identical: both estimators replay through the
  copied ``allocator.CUDA_CACHING`` policy the same ``RequestMix`` or
  scripted stream, ``ServingKnobs`` and ``kv_bytes_per_token``, and give
  the same ``paged_kv_peak_bytes``, ``paged_kv_steady_bytes``,
  ``monolithic_cache_bytes``, ticks, evictions, occupancy and page bytes.
  The decode step is ``tests/test_serving.py``'s, in torch.
* ``persistent_bytes`` (the parameters) and ``_leading_dim`` are
  byte-exact.
* Not held, a stated difference: ``step_transient_bytes``. The two op
  graphs differ; in the GPU preset the port's step holds cuBLAS's
  workspace, once, where the JAX package has none; and the port counts
  the step's output in the transient, where the JAX package's code
  leaves it out. At the traced batch it is exactly
  ``estimate_serving``'s live-tensor peak above the parameters and
  cache.
* The reference's properties (``tests/test_serving.py``), the serving
  sweep's trace budget, ``parse_mix`` and ``ServingEstimate.to_json``.
"""
import itertools

import jax.numpy as jnp
import pytest
import torch

from repro.core import allocator as jalloc
from repro.core import orchestrator as jorch
from repro.core.cache import TraceCache as JaxTraceCache
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.core.estimator import _leading_dim as jax_leading_dim
from repro.launch.serve import parse_mix as jax_parse_mix
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core.allocator import CUDA_CACHING
from repro_torch.core.estimator import XMemEstimator, _leading_dim
from repro_torch.core.sweep import SweepService
from repro_torch.launch.serve import parse_mix

KV_TOK = 1 << 20        # 1 MiB a token keeps paged deltas above the
#                         allocator's segment granularity


def _jax_decode_fn(params, cache, batch):
    h = batch @ params["w"]
    return (h + jnp.sum(cache["k"]) + jnp.sum(cache["v"])) @ params["w"].T


@torch.no_grad()
def _decode_fn(params, cache, batch):
    h = batch @ params["w"]
    return (h + cache["k"].sum() + cache["v"].sum()) @ params["w"].T


def _jax_shapes(b=4):
    return ({"w": jnp.zeros((64, 128))},
            {"k": jnp.zeros((4, 32, 2, 64)), "v": jnp.zeros((4, 32, 2, 64))},
            jnp.zeros((b, 64)))


def _shapes(b=4):
    def meta(*shape):
        return torch.empty(shape, device="meta")
    return ({"w": meta(64, 128)},
            {"k": meta(4, 32, 2, 64), "v": meta(4, 32, 2, 64)},
            meta(b, 64))


def _scripted(mod):
    """Staggered arrivals, mixed prompt/decode lengths, one eviction."""
    return mod.RequestStream((
        mod.RequestSpec(0, 32, 24),
        mod.RequestSpec(1, 8, 64, shared_prefix_len=8),
        mod.RequestSpec(3, 48, 8, shared_prefix_len=8),
        mod.RequestSpec(5, 16, 40, evict_at=12),
        mod.RequestSpec(9, 24, 16),
    ))


def _evicting(mod):
    return mod.RequestStream((mod.RequestSpec(0, 16, 32),
                              mod.RequestSpec(1, 16, 32, evict_at=10),
                              mod.RequestSpec(2, 16, 32)))


# case -> (stream maker, knobs, kv bytes a token, resident bytes)
CASES = {
    "scripted": (_scripted, dict(page_size=8, max_concurrent=3,
                                 speculative_k=2), KV_TOK, 4096),
    "evicting": (_evicting, dict(page_size=8, max_concurrent=2), KV_TOK, 0),
    "fragmented": (lambda m: m.RequestMix(
        buckets=((8, 8, 12), (16, 16, 6), (240, 16, 1)),
        arrival_period=1).stream(),
        dict(page_size=16, max_concurrent=8), KV_TOK, 0),
    "prefix_fp8": (lambda m: m.RequestMix(
        buckets=((64, 8, 6),), arrival_period=1,
        shared_prefix_len=48).stream(),
        dict(page_size=8, max_concurrent=4, kv_dtype_bytes=1), KV_TOK, 0),
    "prefix_off": (lambda m: m.RequestMix(
        buckets=((64, 8, 6),), arrival_period=1,
        shared_prefix_len=48).stream(),
        dict(page_size=8, max_concurrent=4, prefix_cache=False), KV_TOK, 0),
    "plan_mix": (lambda m: m.RequestMix(
        buckets=((256, 64, 8), (64, 256, 8)), arrival_period=1,
        shared_prefix_len=64).stream(),
        dict(page_size=16, max_concurrent=16, kv_dtype_bytes=1), 1 << 18,
        0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_half_is_bit_identical_to_the_reference(case):
    make, knobs, kv_tok, resident = CASES[case]
    want = JaxEstimator(allocator_policy=jalloc.CUDA_CACHING,
                        trace_cache=JaxTraceCache()).estimate_request_stream(
        _jax_decode_fn, *_jax_shapes(), stream=make(jorch),
        knobs=jorch.ServingKnobs(**knobs), kv_bytes_per_token=kv_tok,
        resident_bytes_per_request=resident)
    got = XMemEstimator(allocator_policy=CUDA_CACHING).estimate_request_stream(
        _decode_fn, *_shapes(), stream=make(torch_orch),
        knobs=torch_orch.ServingKnobs(**knobs), kv_bytes_per_token=kv_tok,
        resident_bytes_per_request=resident)
    assert got.paged_kv_peak_bytes == want.paged_kv_peak_bytes > 0
    assert got.paged_kv_steady_bytes == want.paged_kv_steady_bytes
    assert got.monolithic_cache_bytes == want.monolithic_cache_bytes
    assert got.persistent_bytes == want.persistent_bytes == 64 * 128 * 4
    for key in ("num_blocks", "ticks", "evictions", "max_occupancy",
                "page_bytes", "knobs"):
        assert got.breakdown[key] == want.breakdown[key], key
    assert got.sim.peak_allocated == want.sim.peak_allocated
    assert got.sim.curve == want.sim.curve


def test_leading_dim_matches_the_reference():
    cases = [((4, 64),), ((1, 1), (7,)), ((),), ()]
    for shapes in cases:
        want = jax_leading_dim([jnp.zeros(s) for s in shapes])
        got = _leading_dim([torch.empty(s, device="meta") for s in shapes])
        assert got == want
    assert _leading_dim({"tokens": torch.empty((6, 1), device="meta")}) == 6


def test_step_transient_is_the_serving_estimates_at_the_traced_batch():
    est = XMemEstimator.for_torch_gpu()
    params, cache, batch = _shapes(4)
    serve = est.estimate_serving(_decode_fn, params, cache, batch)
    mix = torch_orch.RequestMix(buckets=((8, 8, 4),))
    at_batch = est.estimate_request_stream(
        _decode_fn, params, cache, batch, stream=mix.stream(),
        knobs=torch_orch.ServingKnobs(max_concurrent=4),
        kv_bytes_per_token=KV_TOK)
    resident = serve.breakdown["persistent_by_kind"]
    assert resident["output"] > 0       # the step's output: transient
    assert at_batch.step_transient_bytes == \
        serve.peak_tensor_bytes - resident["param"] - resident["cache"]
    # the workspace is one per handle: added once, not per sequence
    doubled = est.estimate_request_stream(
        _decode_fn, params, cache, batch, stream=mix.stream(),
        knobs=torch_orch.ServingKnobs(max_concurrent=8),
        kv_bytes_per_token=KV_TOK)
    ws = est.cublas_workspace
    assert doubled.step_transient_bytes - ws == \
        2 * (at_batch.step_transient_bytes - ws)


# -- the reference's properties (tests/test_serving.py) -----------------------
def test_paged_below_monolithic_for_fragmented_mix():
    mix = torch_orch.RequestMix(
        buckets=((8, 8, 12), (16, 16, 6), (240, 16, 1)), arrival_period=1)
    se = XMemEstimator.for_torch_gpu().estimate_request_stream(
        _decode_fn, *_shapes(), stream=mix.stream(),
        knobs=torch_orch.ServingKnobs(page_size=16, max_concurrent=8),
        kv_bytes_per_token=KV_TOK)
    assert se.paged_kv_peak_bytes < se.monolithic_cache_bytes
    assert se.steady_state_peak_bytes <= se.worst_case_peak_bytes


def test_prefix_cache_and_kv_dtype_reduce_peak():
    stream = torch_orch.RequestMix(buckets=((64, 8, 6),), arrival_period=1,
                                   shared_prefix_len=48).stream()
    est = XMemEstimator.for_torch_gpu()

    def peak(**knobs):
        return est.estimate_request_stream(
            _decode_fn, *_shapes(), stream=stream,
            knobs=torch_orch.ServingKnobs(**knobs),
            kv_bytes_per_token=KV_TOK).worst_case_peak_bytes

    off = peak(page_size=8, max_concurrent=4, prefix_cache=False)
    assert peak(page_size=8, max_concurrent=4) < off
    assert peak(page_size=8, max_concurrent=4, kv_dtype_bytes=1) < off


# -- the serving sweep --------------------------------------------------------
MIX = torch_orch.RequestMix(buckets=((256, 64, 8), (64, 256, 8)),
                            arrival_period=1, shared_prefix_len=64)
GRID = [torch_orch.ServingKnobs(page_size=p, max_concurrent=c,
                                kv_dtype_bytes=d)
        for p, c, d in itertools.product((8, 16), (4, 8, 16), (1, 2))]


def test_serving_sweep_trace_budget_and_lone_calls():
    assert len(GRID) >= 12
    res = SweepService(XMemEstimator.for_torch_gpu()).estimate_serving_sweep(
        _decode_fn, *_shapes(), stream=MIX.stream(), knob_grid=GRID,
        kv_bytes_per_token=1 << 18)
    assert res.stats["knobs"] == len(GRID)
    assert res.stats["trace_cache"]["misses"] <= 2
    for knobs, got in res:
        lone = XMemEstimator.for_torch_gpu().estimate_request_stream(
            _decode_fn, *_shapes(), stream=MIX.stream(), knobs=knobs,
            kv_bytes_per_token=1 << 18)
        assert got.to_json() == lone.to_json()
    assert len(res.admitted(1 << 62)) == len(GRID)


def test_stream_shares_the_serving_estimates_trace():
    est = XMemEstimator.for_torch_gpu()
    est.estimate_serving(_decode_fn, *_shapes())
    hits, misses = est.trace_cache.hits, est.trace_cache.misses
    est.estimate_request_stream(_decode_fn, *_shapes(), stream=MIX.stream(),
                                kv_bytes_per_token=1 << 18)
    assert est.trace_cache.misses == misses
    assert est.trace_cache.hits == hits + 1


# -- parse_mix and the JSON form ----------------------------------------------
@pytest.mark.parametrize("spec,period,prefix", [
    ("2048:16:8", 1, 0), ("8:8:12,16:16:6,240:16:1", 3, 4),
    ("64:8:6", 0, -2), ("256:64:8,64:256:8", 1, 64)])
def test_parse_mix_matches_the_reference(spec, period, prefix):
    want = jax_parse_mix(spec, period, prefix)
    got = parse_mix(spec, period, prefix)
    assert got.buckets == want.buckets
    assert got.arrival_period == want.arrival_period
    assert got.shared_prefix_len == want.shared_prefix_len
    assert [tuple(vars(r).values()) for r in got.stream().requests] == \
        [tuple(vars(r).values()) for r in want.stream().requests]


def test_to_json_has_the_references_keys():
    want = JaxEstimator(trace_cache=JaxTraceCache()).estimate_request_stream(
        _jax_decode_fn, *_jax_shapes(), stream=_scripted(jorch),
        kv_bytes_per_token=KV_TOK).to_json()
    got = XMemEstimator().estimate_request_stream(
        _decode_fn, *_shapes(), stream=_scripted(torch_orch),
        kv_bytes_per_token=KV_TOK).to_json()
    assert list(got) == list(want)
    assert list(got["breakdown"]) == list(want["breakdown"])
    assert got["knobs"] == want["knobs"]
