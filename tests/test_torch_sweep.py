"""The port's sweep service against the JAX package and against itself.

* The framework-neutral helpers (``_fit_affine``, ``_eval_affine``,
  ``_sweep_scalars``) are bit-identical to the reference on the same
  numpy inputs and on the same spec trees (meta tensors against
  ``ShapeDtypeStruct``s).
* ``_PhaseModel`` is bit-identical to the reference on the reference's
  own traces (qwen3-32b smoke, converted): the same size columns, shape
  tables and input/output blocks at an interpolated batch, and the same
  refusal of a non-affine trio. One stated difference: the port fits
  each row's shape, not each interned shape-table entry, so a trio
  whose shapes coincide at one batch (two shapes equal at batch 2,
  hence one table entry) still models, where the reference refuses it;
  its synthesized shape column and table equal the real trace's.
* A sweep equals sequential ``estimate_training`` to the byte for every
  family (``test_torch_sweep_recurrent.py`` holds the hybrid and SSM
  families), and the dense sweep interpolates. Every family's smoke
  trace is affine in the batch from batch 2 up at these shapes: the
  MoE capacity ``max(8, roundup8(ceil(k T cf / E)))`` is ``24 b`` at
  32 tokens a sequence, four experts, top-2, factor 1.5. Batch 1 differs
  structurally (size-1 dims make some copies no-ops), and the sweep
  repairs it with a probe at batch 2.
* The reference's own sweep cases, the pool, and the batch hillclimb.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sweep_jobs as jobs
from repro.configs import registry as jreg
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.core import sweep as jsw
from repro.core.estimator import XMemEstimator as JaxEstimator
from repro.core.estimator import flatten_kinds as jax_flatten_kinds
from repro.core.events import BlockKind as JaxBlockKind
from repro.models import model as JM
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_estimator_hooks as jax_hooks
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.core import sweep as tsw
from repro_torch.core.estimator import XMemEstimator
from repro_torch.launch import hillclimb as thc
from repro_torch.models import model as TM
from repro_torch.train.train_step import TrainPolicy, make_estimator_hooks
from test_torch_estimator_training import _to_port_phase

SEQ = 32


def reports_equal(a, b):
    assert a.peak_bytes == b.peak_bytes
    assert a.peak_tensor_bytes == b.peak_tensor_bytes
    assert a.persistent_bytes == b.persistent_bytes
    assert a.oom == b.oom
    assert a.num_events == b.num_events
    assert a.breakdown == b.breakdown
    assert a.sim.peak_reserved == b.sim.peak_reserved
    assert a.sim.peak_allocated == b.sim.peak_allocated


def sweep_against_sequential(cfg, batches, seq=SEQ):
    """The sweep's reports and stats, each report held to sequential
    ``estimate_training`` on a fresh cache, to the byte."""
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params = TM.abstract_params(cfg)
    points = [tsw.SweepPoint(fwd, params,
                             treg.input_specs(cfg, smoke_shape(seq, b)),
                             update_fn=upd, opt_init_fn=init)
              for b in batches]
    seq_est = XMemEstimator.for_torch_gpu()
    want = [seq_est.estimate_training(p.fwd_bwd_fn, p.params, p.batch,
                                      update_fn=p.update_fn,
                                      opt_init_fn=p.opt_init_fn)
            for p in points]
    res = tsw.SweepService(XMemEstimator.for_torch_gpu()).estimate_many(
        points)
    for a, b in zip(want, res.reports):
        reports_equal(a, b)
    return res


# -- framework-neutral helpers ------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_fit_and_eval_affine_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 200
    b_lo, b_hi = 2, int(rng.integers(3, 9))
    s0 = rng.integers(0, 1 << 20, n)
    s1 = rng.integers(0, 1 << 12, n)
    exact_lo, exact_hi = s0 + s1 * b_lo, s0 + s1 * b_hi
    for lo, hi in ((exact_lo, exact_hi),
                   (exact_lo, exact_hi + (rng.random(n) < 0.05))):
        want = jsw._fit_affine(lo, hi, b_lo, b_hi)
        got = tsw._fit_affine(lo, hi, b_lo, b_hi)
        assert (want is None) == (got is None)
        if want is None:
            continue
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        for b in range(b_lo, b_hi + 1):
            assert np.array_equal(tsw._eval_affine(got, b),
                                  jsw._eval_affine(want, b))


def _specs(trees):
    """The same batch trees as JAX ``ShapeDtypeStruct``s and as torch
    ``meta`` tensors (dict keys sorted: both packages flatten them in
    that order)."""
    jdt = {"f32": jnp.float32, "i32": jnp.int32}
    tdt = {"f32": torch.float32, "i32": torch.int32}
    jax_trees = [{k: jax.ShapeDtypeStruct(s, jdt[d])
                  for k, (s, d) in sorted(t.items())} for t in trees]
    port_trees = [{k: torch.empty(s, dtype=tdt[d], device="meta")
                   for k, (s, d) in sorted(t.items())} for t in trees]
    return jax_trees, port_trees


SCALAR_CASES = {
    "batch": [{"x": ((b, 8), "f32"), "y": ((b, 8), "i32")}
              for b in (3, 1, 4, 1, 5)],
    "identical": [{"x": ((4, 8), "f32")}] * 3,
    "rank": [{"x": ((4, 8), "f32")}, {"x": ((4,), "f32")}],
    "dtype": [{"x": ((4, 8), "f32")}, {"x": ((5, 8), "i32")}],
    "structure": [{"x": ((4, 8), "f32")}, {"z": ((5, 8), "f32")}],
    "two_dims": [{"x": ((4, 2), "f32"), "y": ((c, 8), "f32")}
                 for c in (1, 2, 3)],
    "seq_dim": [{"x": ((2, s), "i32")} for s in (16, 32, 64)],
}


@pytest.mark.parametrize("case", sorted(SCALAR_CASES))
def test_sweep_scalars_match_the_reference(case):
    jax_trees, port_trees = _specs(SCALAR_CASES[case])
    want = jsw._sweep_scalars([jsw.SweepPoint(None, None, t)
                               for t in jax_trees])
    got = tsw._sweep_scalars([tsw.SweepPoint(None, None, t)
                              for t in port_trees])
    assert got == want


# -- the affine model on the reference's traces -------------------------------
@pytest.fixture(scope="module")
def jax_probes():
    cfg = jreg.get_smoke("qwen3-32b")
    fwd, _, _ = jax_hooks(cfg, JaxTrainPolicy())
    params = JM.abstract_params(cfg)
    est = JaxEstimator.for_torch_gpu()
    phases, expected = {}, {}
    for b in (2, 3, 4, 5, 6):
        batch = jreg.input_specs(cfg, jax_smoke_shape(64, b))
        phases[b] = est.trace_phases(fwd, params, batch)[0]
        flat, _, _ = jax_flatten_kinds(
            [(params, JaxBlockKind.PARAM, "params"),
             (batch, JaxBlockKind.INPUT, "batch")])
        expected[b] = [jsw._aval_nbytes(leaf) for leaf in flat]
    return phases, expected


def _port(entry):
    """A JAX phase in the port's types, its outputs as meta tensors."""
    out = jax.tree_util.tree_map(
        lambda s: torch.empty(tuple(s.shape),
                              dtype=getattr(torch, str(s.dtype)),
                              device="meta"), entry.out_shape)
    return dataclasses.replace(_to_port_phase(entry), out_shape=out,
                               arg_leaf_counts=entry.arg_leaf_counts)


def _blocks(bs):
    return [(b.bid, b.size, b.kind.value, b.shape) for b in bs]


def test_phase_model_synthesizes_what_the_reference_does(jax_probes):
    phases, expected = jax_probes
    trio = (3, 4, 6)
    want_model = jsw._PhaseModel([(b, phases[b]) for b in trio])
    got_model = tsw._PhaseModel([(b, _port(phases[b])) for b in trio])
    assert want_model.ok and got_model.ok
    assert (got_model.b_lo, got_model.b_hi) == (3, 6)
    assert got_model.out_constant == want_model.out_constant
    want = want_model.synthesize(5, expected[5])
    got = got_model.synthesize(5, expected[5])
    wc, gc = want.trace.columnar(), got.trace.columnar()
    assert np.array_equal(gc.size, wc.size)
    assert np.array_equal(gc.shape, wc.shape)
    assert gc.shape_table == wc.shape_table
    assert [b.size for b in got.lifecycles] == \
        [b.size for b in want.lifecycles]
    assert [b.shape for b in got.lifecycles] == \
        [b.shape for b in want.lifecycles]
    assert _blocks(got.input_blocks) == _blocks(want.input_blocks)
    assert _blocks(got.output_blocks) == _blocks(want.output_blocks)
    assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(
        got.out_shape)] == [tuple(s.shape) for s in
                            jax.tree_util.tree_leaves(want.out_shape)]
    # and both are the real trace at batch 5, sizes and shapes
    real = phases[5].trace.columnar()
    assert np.array_equal(gc.size, real.size)
    assert gc.shape_table == real.shape_table
    # outside the probed range, or with other input bytes: no trace
    assert got_model.synthesize(7, expected[5]) is None
    assert got_model.synthesize(5, expected[4]) is None
    assert want_model.synthesize(5, expected[4]) is None


def test_phase_model_refuses_the_trio_the_reference_refuses(jax_probes):
    phases, _ = jax_probes
    # the traces of batches 3, 4 and 6 labelled 3, 5 and 6: the middle
    # probe is off the line through the outer two
    trio = ((3, phases[3]), (5, phases[4]), (6, phases[6]))
    assert not jsw._PhaseModel(list(trio)).ok
    assert not tsw._PhaseModel([(b, _port(p)) for b, p in trio]).ok


def test_phase_model_fits_shapes_that_coincide_at_one_batch(jax_probes):
    # at batch 2 two of the trace's shapes coincide, so its interned
    # shape column differs from batch 4's and 6's: the reference refuses
    # the trio; the port models each row's shape and re-interns them
    phases, expected = jax_probes
    trio = (2, 4, 6)
    assert not np.array_equal(phases[2].trace.columnar().shape,
                              phases[4].trace.columnar().shape)
    assert not jsw._PhaseModel([(b, phases[b]) for b in trio]).ok
    model = tsw._PhaseModel([(b, _port(phases[b])) for b in trio])
    assert model.ok
    for b in (3, 5):
        got = model.synthesize(b, expected[b]).trace.columnar()
        real = phases[b].trace.columnar()
        assert np.array_equal(got.size, real.size)
        assert np.array_equal(got.shape, real.shape)
        assert got.shape_table == real.shape_table


# -- sweep against sequential, on the port's own traces -----------------------
FAMILIES = {"dense": "qwen3-32b", "moe": "phi3.5-moe-42b-a6.6b",
            "vlm": "internvl2-1b", "audio": "musicgen-medium"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sweep_equals_sequential(family):
    res = sweep_against_sequential(treg.get_smoke(FAMILIES[family]),
                                   (1, 2, 3, 4, 5, 6))
    # probes 1, 4, 6; 1 differs structurally, so 2 repairs it; 3 and 5
    # are synthesized
    assert res.sources == ["probe", "probe", "interpolated", "probe",
                           "interpolated", "probe"]
    assert res.stats["model"] == [2, 6]
    assert res.stats["interpolated"] == 2 and res.stats["fallback"] == 0


def test_sweep_reuses_traces_made_through_other_hooks():
    # a gate's trace, made through hooks built for it, serves the sweep's
    # probe: the cache key is the functions' content, not their identity
    cfg = treg.get_smoke("qwen3-32b")
    params = TM.abstract_params(cfg)
    est = XMemEstimator.for_torch_gpu()
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    gate = est.estimate_training(
        fwd, params, treg.input_specs(cfg, smoke_shape(SEQ, 4)),
        update_fn=upd, opt_init_fn=init)
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    points = [tsw.SweepPoint(fwd, params,
                             treg.input_specs(cfg, smoke_shape(SEQ, b)),
                             update_fn=upd, opt_init_fn=init)
              for b in range(1, 9)]
    res = tsw.SweepService(est).estimate_many(points)
    # probes 1, 5, 8 and the repair at 2 are the only new traces
    assert res.stats["trace_cache"]["misses"] == 4
    assert res.sources[3] == "interpolated"
    reports_equal(res.reports[3], gate)


# -- the reference's own cases (tests/test_columnar.py) -----------------------
def _points(batches):
    params, _ = jobs.shapes()
    return [tsw.SweepPoint(jobs.fwd_bwd, params, jobs.shapes(b)[1],
                           update_fn=jobs.adam, opt_init_fn=jobs.adam_init)
            for b in batches]


def test_interpolated_sweep_matches_sequential():
    points = _points([4 * i for i in range(1, 9)])
    seq_est = XMemEstimator.for_torch_gpu()
    seq = [seq_est.estimate_training(
        p.fwd_bwd_fn, p.params, p.batch, update_fn=p.update_fn,
        opt_init_fn=p.opt_init_fn) for p in points]
    res = tsw.SweepService(XMemEstimator.for_torch_gpu()).estimate_many(
        points)
    assert res.stats["interpolated"] > 0
    for a, b in zip(seq, res.reports):
        reports_equal(a, b)


def test_nonaffine_workload_falls_back_exactly():
    # Gram matrix x @ x.T: internal sizes are quadratic in the batch, so
    # the affine model refuses itself (the middle probe is off the line)
    # and every point is still exact through the full pipeline
    params = {"w": torch.empty((jobs.D, jobs.D), device="meta")}
    points = [tsw.SweepPoint(
        jobs.gram_fwd_bwd, params,
        {"x": torch.empty((b, jobs.D), device="meta")})
        for b in (3, 5, 7, 9, 11, 13)]
    seq_est = XMemEstimator.for_torch_gpu()
    seq = [seq_est.estimate_training(p.fwd_bwd_fn, p.params, p.batch)
           for p in points]
    res = tsw.SweepService(XMemEstimator.for_torch_gpu()).estimate_many(
        points)
    assert res.stats["interpolated"] == 0
    assert res.stats["model"] is None
    for a, b in zip(seq, res.reports):
        reports_equal(a, b)


def test_identical_points_share_traces():
    res = tsw.SweepService(XMemEstimator.for_torch_gpu()).estimate_many(
        _points([8, 8, 8]))
    assert len({r.peak_bytes for r in res.reports}) == 1
    # the second and third point hit the warm cache (3 phases each)
    assert res.stats["cache"]["hits"] >= 6


def test_heterogeneous_ranks_fall_back():
    params, data = jobs.shapes(8)
    p1 = tsw.SweepPoint(jobs.fwd_bwd, params, data)
    p2 = tsw.SweepPoint(jobs.fwd_bwd, params,
                        {"x": torch.empty((4, jobs.D), device="meta"),
                         "y": torch.empty((4, jobs.D), device="meta")})
    res = tsw.SweepService(XMemEstimator.for_torch_gpu()).estimate_many(
        [p1, p2])
    assert len(res.reports) == 2
    assert res.stats["interpolated"] == 0


# -- the pool -----------------------------------------------------------------
def test_pool_gives_the_inline_reports_and_imports_no_jax():
    points = _points([4 * i for i in range(1, 9)])
    inline = tsw.estimate_many(points,
                               estimator=XMemEstimator.for_torch_gpu())
    with tsw.SweepService(XMemEstimator.for_torch_gpu(),
                          processes=2) as svc:
        svc.warm_up()
        pooled = svc.estimate_many(points)
        # a worker's imports, after it estimated: eval of the expression
        # in the worker process (the builtin pickles by name)
        modules = svc._get_pool().submit(
            eval, "sorted(__import__('sys').modules)").result()
    assert pooled.stats["pooled"] > 0
    assert pooled.stats["interpolated"] == inline.stats["interpolated"]
    assert pooled.sources == inline.sources
    for a, b in zip(inline.reports, pooled.reports):
        reports_equal(a, b)
    assert "repro_torch.core.sweep" in modules
    assert not [m for m in modules if m in ("jax", "repro")
                or m.startswith(("jax.", "repro."))]


def test_pool_payloads_pickle():
    params, data = jobs.shapes(4)
    est = XMemEstimator.for_torch_gpu()
    fwd, upd, init = est.trace_phases(jobs.fwd_bwd, params, data, jobs.adam,
                                      jobs.adam_init)
    shipped = pickle.loads(pickle.dumps(
        tsw.SweepService._strip_for_pool(fwd)))
    assert list(shipped.lifecycles) == list(fwd.lifecycles)
    reports_equal(est.estimate_from_phases(shipped, upd, init),
                  est.estimate_from_phases(fwd, upd, init))


# -- the batch hillclimb ------------------------------------------------------
def test_hillclimb_picks_the_largest_batch_that_fits(tmp_path):
    cfg = treg.get_smoke("qwen3-32b")
    fwd, upd, init = make_estimator_hooks(cfg, TrainPolicy())
    params = TM.abstract_params(cfg)
    grid = thc.batch_grid(32)
    assert grid == [1, 2, 4, 8, 16, 32]
    est = XMemEstimator.for_torch_gpu()
    unbounded = [est.estimate_training(
        fwd, params, treg.input_specs(cfg, smoke_shape(SEQ, b)),
        update_fn=upd, opt_init_fn=init).peak_bytes for b in grid]
    # a capacity between two of the grid's estimates
    capacity = (unbounded[3] + unbounded[4]) // 2
    assert unbounded[3] < capacity < unbounded[4]
    fits = []
    for b in grid:
        rep = est.estimate_training(
            fwd, params, treg.input_specs(cfg, smoke_shape(SEQ, b)),
            update_fn=upd, opt_init_fn=init, capacity=capacity)
        fits.append(not rep.oom and rep.peak_bytes <= capacity)
    want = max(b for b, ok in zip(grid, fits) if ok)
    out = thc.xmem_batch_hillclimb("qwen3-32b", capacity, seq=SEQ,
                                   max_batch=32, verbose=False,
                                   timeline_out=str(tmp_path / "tl.json"))
    assert out["best_batch"] == want == 8
    assert [p["fits"] for p in out["probes"]] == fits
    assert out["sweep"]["points"] == len(grid)
    assert out["sweep"]["interpolated"] > 0
    assert want == 8 and unbounded[3] <= out["min_feasible_capacity"] \
        <= capacity
    assert (tmp_path / "tl.json").stat().st_size > 0


def test_hillclimb_grid_snaps_to_microbatches():
    assert thc.batch_grid(32, 4) == [4, 8, 16, 32]
    assert thc.batch_grid(2, 4) == [4]


def test_hillclimb_main_needs_a_capacity_on_the_cpu(tmp_path):
    with pytest.raises(SystemExit) as e:
        thc.main(["--xmem-batch", "qwen3-32b", "--smoke", "--device", "cpu",
                  "--out", str(tmp_path)])
    assert e.value.code == 2
    assert thc.main(["--xmem-batch", "qwen3-32b", "--smoke", "--device",
                     "cpu", "--capacity-gib", "1", "--max-batch", "4",
                     "--seq", "16", "--out", str(tmp_path)]) == 0
    assert (tmp_path / "xmem_batch__qwen3-32b.json").exists()
