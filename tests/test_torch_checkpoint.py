"""The port's checkpoints and straggler monitor against the JAX package.

``repro_torch.train.checkpoint`` writes the JAX package's format (npz of
``a<i>`` leaves in JAX's flattening order, a manifest with keystr paths,
dtype strings and a sha256), so a checkpoint made by either package
restores in the other; ``launch.train.train_loop`` resumes from it.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import registry as jreg
from repro.configs.base import smoke_shape as jax_smoke_shape
from repro.models import model as JM
from repro.train import data as jdata
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.elastic import StragglerMonitor as JaxStragglerMonitor
from repro.train.train_step import TrainPolicy as JaxTrainPolicy
from repro.train.train_step import make_train_step as jax_train_step
from repro_torch.configs import registry as treg
from repro_torch.configs.base import smoke_shape
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.train import CheckpointManager, StragglerMonitor
from repro_torch.train import data as tdata
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.train_step import TrainPolicy, make_train_step

ARCH = "internvl2-1b"


def _cfgs(dtype):
    import dataclasses
    return [dataclasses.replace(reg.get_smoke(ARCH), param_dtype=dtype)
            for reg in (jreg, treg)]


def _like(cfg, opt):
    meta = TM.abstract_params(cfg)
    return {"params": meta, "opt_state": opt.init(meta)}


def _equal_bytes(port, ref):
    """Each leaf of ``port`` (tensors) holds the bytes of the JAX tree
    ``ref``'s leaf at the same path."""
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    got = dict(_flatten(port))
    assert [jax.tree_util.keystr(p) for p, _ in want] == list(got)
    for path, a in want:
        t = got[jax.tree_util.keystr(path)]
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape and str(t.dtype)[6:] == str(a.dtype)
        if a.dtype.name == "bfloat16":
            t, a = t.view(torch.int16), a.view(np.int16)
        np.testing.assert_array_equal(t.numpy(), a)


def _jax_state(jcfg, steps):
    """JAX parameters and AdamW state after ``steps`` steps of batch
    ``0..steps-1``, and the step function."""
    step_fn, opt = jax_train_step(jcfg, JaxTrainPolicy())
    step_fn = jax.jit(step_fn)
    ds = jdata.SyntheticDataset(jcfg, jax_smoke_shape(24, 2))
    params = JM.init_params(jcfg, jax.random.key(0))
    state = opt.init(params)
    for s in range(steps):
        batch = jax.tree_util.tree_map(jnp.asarray, ds.batch(s))
        _, params, state = step_fn(params, state, batch)
    return params, state, step_fn, ds


# ---------------------------------------------------------------------------
# the format
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int32, torch.int64])
def test_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 5, generator=g) * 100).to(dtype)
    state = {"b": {"x": x, "list": [x[0], x[1:]]}, "a": torch.tensor(7),
             "empty": (), "none": None}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state)
    step, got = mgr.restore_latest(state, device="cpu")
    assert step == 4 and got["none"] is None and got["empty"] == ()
    for (p, t), (q, u) in zip(_flatten(state), _flatten(got)):
        assert p == q and u.dtype == t.dtype and u.shape == t.shape
        assert torch.equal(u, t)
    with open(tmp_path / "ckpt_step0000000004_shard0.manifest.json") as f:
        m = json.load(f)
    assert m["paths"] == ["['a']", "['b']['list'][0]", "['b']['list'][1]",
                          "['b']['x']"]
    assert m["dtypes"][1] == str(dtype).removeprefix("torch.")


def test_interrupted_saves_and_a_corrupt_newest_are_skipped(tmp_path):
    x = {"w": torch.arange(6, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, x)
    mgr.save(4, {"w": x["w"] * 2})
    # a save cut short before its commit leaves only .tmp files
    base = tmp_path / "ckpt_step0000000006_shard0"
    (tmp_path / (base.name + ".npz.tmp")).write_bytes(b"partial")
    (tmp_path / (base.name + ".manifest.json.tmp")).write_text("{")
    # a manifest torn mid-write is no checkpoint
    (tmp_path / "ckpt_step0000000008_shard0.manifest.json").write_text('{"st')
    assert mgr.latest_step() == 4
    step, got = mgr.restore_latest(x, device="cpu")
    assert step == 4 and torch.equal(got["w"], x["w"] * 2)
    # the newest file corrupted: its digest fails, the older one restores
    npz = tmp_path / "ckpt_step0000000004_shard0.npz"
    raw = bytearray(npz.read_bytes())
    raw[-100] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        mgr.restore(4, x, device="cpu")
    step, got = mgr.restore_latest(x, device="cpu")
    assert step == 2 and torch.equal(got["w"], x["w"])


def test_retention_keeps_the_last_and_never_an_emergency(tmp_path):
    x = {"w": torch.zeros(2)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.emergency(1, x)
    for step in (2, 3, 4, 5):
        mgr.save(step, x)
    names = sorted(os.listdir(tmp_path))
    assert names == [
        "ckpt_step0000000004_shard0.manifest.json",
        "ckpt_step0000000004_shard0.npz",
        "ckpt_step0000000005_shard0.manifest.json",
        "ckpt_step0000000005_shard0.npz",
        "emergency_step0000000001_shard0.manifest.json",
        "emergency_step0000000001_shard0.npz"]
    assert mgr.latest_step("emergency") == 1
    # the newer of the two tags restores; at one step, the emergency one
    mgr.emergency(5, {"w": torch.ones(2)})
    step, got = mgr.restore_latest(x, device="cpu")
    assert step == 5 and torch.equal(got["w"], torch.ones(2))


def test_restore_checks_structure_shape_and_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(2, 3)})
    for like in ({"v": torch.zeros(2, 3)}, {"w": torch.zeros(3, 2)},
                 {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}):
        with pytest.raises(ValueError):
            mgr.restore(1, like, device="cpu")


# ---------------------------------------------------------------------------
# across the two packages
def test_jax_checkpoint_restores_in_the_port_and_steps_alike(tmp_path):
    # f32: the JAX package's parameters and AdamW state after one step,
    # restored in the port, give the JAX package's next-step loss and
    # update; the port's checkpoint of the result restores in the JAX
    # package leaf for leaf
    jcfg, tcfg = _cfgs("float32")
    jp, js, jstep, ds = _jax_state(jcfg, 1)
    JaxCheckpointManager(str(tmp_path / "jax")).save(
        1, {"params": jp, "opt_state": js})
    step_fn, opt = make_train_step(tcfg, TrainPolicy())
    step, state = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        _like(tcfg, opt), device="cpu")
    assert step == 1
    _equal_bytes(state, {"params": jp, "opt_state": js})
    batch = ds.batch(1)
    want_loss, jp2, js2 = jstep(
        jp, js, jax.tree_util.tree_map(jnp.asarray, batch))
    loss = step_fn(state["params"], state["opt_state"],
                   {k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    CheckpointManager(str(tmp_path / "port")).save(2, state)
    step, back = JaxCheckpointManager(str(tmp_path / "port")).restore_latest(
        {"params": jp2, "opt_state": js2})
    assert step == 2
    for a, t in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(np.asarray, {
                            "params": jp2, "opt_state": js2}))):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(t, np.float32),
                                   rtol=1e-4, atol=1e-5)


def test_bf16_checkpoints_cross_the_packages_byte_for_byte(tmp_path):
    jcfg, tcfg = _cfgs("bfloat16")
    jp, js, _, _ = _jax_state(jcfg, 1)
    assert jax.tree_util.tree_leaves(jp)[0].dtype == jnp.bfloat16
    JaxCheckpointManager(str(tmp_path)).save(3, {"params": jp,
                                                 "opt_state": js})
    opt = make_train_step(tcfg, TrainPolicy())[1]
    step, state = CheckpointManager(str(tmp_path)).restore_latest(
        _like(tcfg, opt), device="cpu")
    assert step == 3
    _equal_bytes(state, {"params": jp, "opt_state": js})
    CheckpointManager(str(tmp_path)).save(4, state)
    step, back = JaxCheckpointManager(str(tmp_path)).restore_latest(
        {"params": jp, "opt_state": js})
    assert step == 4
    _equal_bytes(state, back)


# ---------------------------------------------------------------------------
# the training loop
def _loop(tmp_path, steps, **kw):
    cfg = treg.get_smoke(ARCH)
    run = ttrain.train_loop(cfg, smoke_shape(24, 2), TrainPolicy(),
                            steps=steps, device="cpu", seed=0,
                            ckpt_dir=str(tmp_path), **kw)
    return run


def test_interrupted_loop_resumes_to_the_uninterrupted_losses(
        tmp_path, monkeypatch, capsys):
    whole = _loop(tmp_path / "whole", 6, ckpt_every=2)
    assert len(whole.losses) == 6 and all(map(math.isfinite, whole.losses))
    batch = tdata.SyntheticDataset.device_batch

    def failing(self, step, device="cuda"):
        if step == 3:
            raise KeyboardInterrupt("preempted")
        return batch(self, step, device)
    monitors = []

    class Recorded(StragglerMonitor):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            monitors.append(self)
    with monkeypatch.context() as m:
        m.setattr(tdata.SyntheticDataset, "device_batch", failing)
        m.setattr(ttrain, "StragglerMonitor", Recorded)
        with pytest.raises(KeyboardInterrupt):
            _loop(tmp_path / "cut", 6, ckpt_every=2)
    # the three steps before the cut were timed as worker 0's
    assert len(monitors) == 1 and len(monitors[0]._times[0]) == 3
    mgr = CheckpointManager(str(tmp_path / "cut"))
    assert mgr.latest_step() == 2 and mgr.latest_step("emergency") == 3
    assert "emergency checkpoint at step 3" in capsys.readouterr().out
    rest = _loop(tmp_path / "cut", 6, ckpt_every=2)
    assert rest.step == 6 and len(rest.losses) == 3
    assert "resumed from step 3" in capsys.readouterr().out
    np.testing.assert_allclose(rest.losses, whole.losses[3:], rtol=1e-6)
    assert mgr.latest_step() == 6


def test_an_update_cut_short_saves_no_emergency_checkpoint(
        tmp_path, monkeypatch):
    hooks = ttrain.make_estimator_hooks

    def torn(cfg, policy):
        fwd_bwd, update, opt_init = hooks(cfg, policy)

        def update_then_fail(params, grads, state):
            update(params, grads, state)
            if int(state["count"]) == 2:
                raise RuntimeError("device lost mid-update")
        return fwd_bwd, update_then_fail, opt_init
    monkeypatch.setattr(ttrain, "make_estimator_hooks", torn)
    with pytest.raises(RuntimeError, match="mid-update"):
        _loop(tmp_path, 4, ckpt_every=1)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1 and mgr.latest_step("emergency") is None


def test_train_launcher_resumes_from_its_checkpoints(tmp_path, capsys):
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--seq", "24",
            "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    assert ttrain.main(args + ["--steps", "2"]) == 0
    assert ttrain.main(args + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step   2 loss" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_no_ckpt_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = ttrain.train_loop(treg.get_smoke(ARCH), smoke_shape(24, 2),
                            TrainPolicy(), steps=2, device="cpu")
    assert run.step == 2 and list(tmp_path.iterdir()) == []
    assert pytree.tree_leaves(run.opt_state)


# ---------------------------------------------------------------------------
# the straggler monitor
@pytest.mark.parametrize("seed,slow", [(0, ()), (1, (3,)), (2, (0, 5)),
                                       (3, (1, 2, 4))])
def test_straggler_monitor_flags_what_the_jax_one_flags(seed, slow):
    rng = np.random.default_rng(seed)
    port, ref = StragglerMonitor(6, window=8), JaxStragglerMonitor(6, window=8)
    for _ in range(12):
        for w in range(6):
            t = float(rng.normal(1.0, 0.01)) + (0.5 if w in slow else 0.0)
            port.record(w, t)
            ref.record(w, t)
    assert port.stragglers() == ref.stragglers()
    assert port.reassignment_plan() == ref.reassignment_plan()
    if len(slow) < 3:
        assert port.stragglers() == list(slow)
    port.forget(5)
    ref.forget(5)
    assert port.stragglers() == ref.stragglers()
