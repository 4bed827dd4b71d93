"""The port's persistent trace store.

* A ``TracedPhase`` round-trips through ``phase_to_json`` /
  ``phase_from_json`` field by field: the trace's columns, every
  lifecycle, the input/output blocks, the argument leaf counts and the
  abstract outputs (bf16 and int64 among them, read back as the same
  ``torch.dtype``).
* A restarted service over the same ``store_dir`` answers with zero
  retraces, bit-identically, from ``disk``; so does a second process:
  ``subprocess`` runs that write and then read give the same digest and
  the same decision.
* The reference's store cases: LRU eviction, version invalidation,
  corrupt, truncated, zero-byte and orphan ``.tmp`` quarantine, the
  mid-write crash by fault injection, and unique temp names.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import torch

import torch_service_jobs as jobs
from repro_torch.core.cache import TraceCache, stable_key_digest, trace_key
from repro_torch.core.estimator import XMemEstimator, flatten_kinds
from repro_torch.core.events import TRACE_SCHEMA_VERSION, BlockKind, Phase
from repro_torch.service import (AdmissionService, FaultPlan, FaultSpec,
                                 TraceStore, plan_raising_at)
from repro_torch.service.store import (STORE_VERSION, _PREFIX,
                                       phase_from_json, phase_to_json)
from torch.utils import _pytree as pytree

ROOT = Path(__file__).resolve().parents[1]


def _same_phase(back, entry):
    assert back.trace.num_iterations == entry.trace.num_iterations
    a, b = back.trace.columnar(), entry.trace.columnar()
    assert a.to_json() == b.to_json()
    assert back.num_events == entry.num_events
    assert back.lifecycles == tuple(entry.lifecycles)
    assert back.input_blocks == entry.input_blocks
    assert back.output_blocks == entry.output_blocks
    assert back.arg_leaf_counts == entry.arg_leaf_counts
    assert pytree.tree_structure(back.out_shape) == \
        pytree.tree_structure(entry.out_shape)
    for x, y in zip(pytree.tree_leaves(back.out_shape),
                    pytree.tree_leaves(entry.out_shape)):
        if y is None:
            assert x is None
            continue
        assert (x.shape, x.dtype, x.device.type) == \
            (y.shape, y.dtype, "meta")


def _mixed_step(params, batch):
    """Outputs of three dtypes: bf16 logits, int64 ids, an f32 loss."""
    logits = (batch["x"] @ params["w"]).to(torch.bfloat16)
    return {"logits": logits, "ids": logits.float().argmax(-1),
            "loss": [logits.float().mean(), None]}


def test_phase_round_trip_is_field_by_field_equal():
    est = XMemEstimator.for_torch_gpu()
    fwd_bwd, adam, adam_init = jobs.make_hooks()
    params, data = jobs.shapes()
    entries = list(est.trace_phases(fwd_bwd, params, data, adam,
                                    adam_init))
    entries.append(est._trace_phase(
        _mixed_step, [({"w": torch.empty((jobs.D, 16), device="meta")},
                       BlockKind.PARAM, "params"),
                      (data, BlockKind.INPUT, "batch")],
        Phase.DECODE, tag="serve"))
    dtypes = {x.dtype for x in pytree.tree_leaves(entries[-1].out_shape)
              if x is not None}
    assert {torch.bfloat16, torch.int64, torch.float32} <= dtypes
    for entry in entries:
        back = phase_from_json(json.loads(json.dumps(phase_to_json(entry))))
        _same_phase(back, entry)


def test_restart_zero_retrace_bit_identical(tmp_path):
    sd = str(tmp_path / "store")
    svc = AdmissionService(workers=1, store_dir=sd)
    d1 = svc.decide(jobs.request("cold"))
    assert d1.provenance["source"] == "traced"
    svc.close()
    svc2 = AdmissionService(workers=1, store_dir=sd)
    d2 = svc2.decide(jobs.request("warm-after-restart"))
    assert d2.provenance["source"] == "disk"
    assert d2.provenance["trace_cache"] == {"hits": 0, "misses": 0,
                                            "store_hits": 3}
    for f in ("peak_bytes", "peak_tensor_bytes", "persistent_bytes",
              "admit", "breakdown"):
        assert getattr(d2, f) == getattr(d1, f), f
    assert d2.report.num_events == d1.report.num_events
    assert d2.report.sim.peak_reserved == d1.report.sim.peak_reserved
    svc2.close()


_CHILD = """
import json, sys
sys.path[:0] = [{src!r}, {tests!r}]
import torch_service_jobs as jobs
from repro_torch.core.cache import stable_key_digest, trace_key
from repro_torch.core.estimator import flatten_kinds
from repro_torch.core.events import BlockKind, Phase
from repro_torch.service import AdmissionService
from torch.utils import _pytree as pytree
fwd, _, _ = jobs.make_hooks()
params, data = jobs.shapes()
args = [(params, BlockKind.PARAM, "params"), (data, BlockKind.INPUT, "batch")]
flat, kinds, _ = flatten_kinds(args)
key = trace_key(fwd, "fwd", flat, tuple(pytree.tree_structure(t)
                                        for t, _, _ in args), kinds,
                Phase.FORWARD_BACKWARD)
svc = AdmissionService(workers=1, store_dir=sys.argv[1])
d = svc.decide(jobs.request("child"))
print(json.dumps({{"digest": stable_key_digest(key),
                  "source": d.provenance["source"],
                  "decision": [d.peak_bytes, d.peak_tensor_bytes,
                               d.persistent_bytes, d.admit,
                               d.breakdown["phase_peaks"]]}}))
"""


def test_two_processes_share_the_store(tmp_path):
    code = _CHILD.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    sd = str(tmp_path / "store")
    outs = [json.loads(subprocess.run(
        [sys.executable, "-c", code, sd], capture_output=True, text=True,
        env=env, timeout=300, check=True).stdout.splitlines()[-1])
        for _ in range(2)]
    assert outs[0]["digest"] == outs[1]["digest"]
    assert [o["source"] for o in outs] == ["traced", "disk"]
    assert outs[0]["decision"] == outs[1]["decision"]
    # this process names the entry the same way
    fwd, _, _ = jobs.make_hooks()
    params, data = jobs.shapes()
    args = [(params, BlockKind.PARAM, "params"),
            (data, BlockKind.INPUT, "batch")]
    flat, kinds, _ = flatten_kinds(args)
    key = trace_key(fwd, "fwd", flat, tuple(pytree.tree_structure(t)
                                            for t, _, _ in args),
                    kinds, Phase.FORWARD_BACKWARD)
    assert stable_key_digest(key) == outs[0]["digest"]
    assert os.path.exists(TraceStore(sd).path_for(key))


# -- the reference's store cases ----------------------------------------------
def _entry_files(sd):
    return [os.path.join(sd, n) for n in os.listdir(sd)
            if n.startswith(_PREFIX) and n.endswith(".json")]


def _qfiles(sd):
    qdir = os.path.join(sd, "quarantine")
    return os.listdir(qdir) if os.path.isdir(qdir) else []


def _decide_store(sd, job="job"):
    svc = AdmissionService(workers=1, store_dir=sd)
    d = svc.decide(jobs.request(job))
    svc.close()
    return d


def test_lru_eviction_on_disk(tmp_path):
    store = TraceStore(str(tmp_path), max_entries=4)
    svc = AdmissionService(workers=1, cache=TraceCache(store=store))
    for i, b in enumerate((2, 4, 6, 8, 10, 12)):
        svc.decide(jobs.request(f"j{i}", batch=b))
    assert len(store) == 4
    svc.close()


def test_version_invalidation(tmp_path):
    sd = str(tmp_path)
    ref = _decide_store(sd)
    assert len(TraceStore(sd)) == 3
    for p in _entry_files(sd):
        with open(p) as f:
            d = json.load(f)
        d["store_version"] = STORE_VERSION + 1
        with open(p, "w") as f:
            json.dump(d, f)
    svc2 = AdmissionService(workers=1, store_dir=sd)
    d = svc2.decide(jobs.request("after-bump"))
    assert d.provenance["source"] == "traced"
    assert d.peak_bytes == ref.peak_bytes
    assert svc2.cache.store.invalidated == 3
    assert any("version" in n for n in _qfiles(sd))
    assert len(svc2.cache.store) == 3
    svc2.close()


def test_truncated_json_quarantined_and_retraced(tmp_path):
    sd = str(tmp_path / "store")
    ref = _decide_store(sd)
    files = _entry_files(sd)
    assert len(files) == 3
    for p in files:
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
    svc2 = AdmissionService(workers=1, store_dir=sd)
    d = svc2.decide(jobs.request("job"))
    assert d.peak_bytes == ref.peak_bytes
    assert d.provenance["source"] == "traced"
    st = svc2.cache.store.stats()
    assert st["quarantined"] == 3 and st["entries"] == 3
    assert any("bad-json" in n for n in _qfiles(sd))
    svc2.close()


def test_corrupt_file_is_a_miss(tmp_path):
    sd = str(tmp_path)
    _decide_store(sd)
    for p in _entry_files(sd):
        with open(p, "w") as f:
            f.write("{not json")
    svc2 = AdmissionService(workers=1, store_dir=sd)
    assert svc2.decide(jobs.request("x")).provenance["source"] == "traced"
    svc2.close()


def test_foreign_payload_quarantined(tmp_path):
    sd = str(tmp_path / "store")
    ref = _decide_store(sd)
    for p in _entry_files(sd):
        with open(p, "w") as f:
            json.dump({"store_version": STORE_VERSION,
                       "trace_schema": TRACE_SCHEMA_VERSION,
                       "phase": {"nonsense": True}}, f)
    svc2 = AdmissionService(workers=1, store_dir=sd)
    assert svc2.decide(jobs.request("job")).peak_bytes == ref.peak_bytes
    assert any("bad-payload" in n for n in _qfiles(sd))
    svc2.close()


def test_zero_byte_entries_quarantined_at_startup(tmp_path):
    sd = str(tmp_path / "store")
    _decide_store(sd)
    files = _entry_files(sd)
    for p in files:
        open(p, "w").close()
    store = TraceStore(sd)
    assert store.recovery["quarantined_empty"] == len(files)
    assert len(store) == 0
    assert any("zero-byte" in n for n in _qfiles(sd))


def test_orphan_tmp_quarantined_at_startup(tmp_path):
    sd = str(tmp_path / "store")
    os.makedirs(sd)
    orphan = os.path.join(sd, _PREFIX + "wdead.tmp")
    with open(orphan, "w") as f:
        f.write('{"half": ')
    store = TraceStore(sd)
    assert store.recovery["quarantined_tmp"] == 1
    assert not os.path.exists(orphan)
    assert any("orphan-tmp" in n for n in _qfiles(sd))


def test_midwrite_crash_via_fault_injection(tmp_path):
    sd = str(tmp_path / "store")
    svc = AdmissionService(workers=1, store_dir=sd)
    svc.set_faults(FaultPlan([FaultSpec("store.save", "truncate",
                                        times=1)]))
    ref = svc.decide(jobs.request("job"))
    svc.close()
    svc2 = AdmissionService(workers=1, store_dir=sd)
    d = svc2.decide(jobs.request("job"))
    assert d.peak_bytes == ref.peak_bytes
    assert svc2.cache.store.stats()["quarantined"] == 1
    assert len(_qfiles(sd)) == 1
    svc2.close()


def test_store_load_fault_still_answers(tmp_path):
    sd = str(tmp_path / "store")
    ref = _decide_store(sd)
    svc2 = AdmissionService(workers=1, store_dir=sd)
    with svc2.inject_faults(plan_raising_at("store.load")):
        d = svc2.decide(jobs.request("job"))
    assert isinstance(d.admit, bool)
    assert d.peak_bytes >= ref.peak_bytes
    svc2.close()


def test_unique_tmp_names_no_clobber(tmp_path):
    sd = str(tmp_path / "store")
    svcs = [AdmissionService(workers=1, store_dir=sd) for _ in range(2)]
    threads = [threading.Thread(target=s.decide,
                                args=(jobs.request("race"),))
               for s in svcs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert [n for n in os.listdir(sd) if n.endswith(".tmp")] == []
    assert TraceStore(sd).recovery["quarantined_tmp"] == 0
    svc3 = AdmissionService(workers=1, store_dir=sd)
    assert svc3.decide(jobs.request("race")).provenance["source"] == "disk"
    for s in (*svcs, svc3):
        s.close()


def test_store_stats_time_loads_and_saves(tmp_path):
    sd = str(tmp_path / "store")
    svc = AdmissionService(workers=1, store_dir=sd)
    svc.decide(jobs.request("timed"))
    st = svc.cache.store.stats()
    assert st["saves"] == 3 and st["save_s"] > 0 and st["load_s"] == 0
    svc2 = AdmissionService(workers=1, store_dir=sd)
    svc2.decide(jobs.request("timed"))
    st2 = svc2.cache.store.stats()
    assert st2["loads"] == 3 and st2["load_s"] > 0
    # clear empties the memory level and the counts, not the disk
    svc2.cache.clear()
    assert len(svc2.cache) == 0 and svc2.cache.stats()["store_hits"] == 0
    assert svc2.cache.thread_stats() == {"hits": 0, "misses": 0,
                                         "store_hits": 0}
    assert svc2.decide(jobs.request("timed")).provenance["source"] == "disk"
    for s in (svc, svc2):
        s.close()
