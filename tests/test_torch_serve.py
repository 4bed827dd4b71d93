"""The port's serving path against the JAX package, its gate, and the
rule that the port and ``chip_smoke.py`` import no JAX and no ``repro``.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.train.train_step import make_prefill_step as jax_prefill_step
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.models import convert

ROOT = Path(__file__).resolve().parents[1]


def _jax_greedy(cfg, params, prompt, max_len, tokens):
    """Prefill argmax, then ``decode_step`` from cache position 0."""
    logits = jax.jit(jax_prefill_step(cfg))(params,
                                            {"tokens": jnp.asarray(prompt)})
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    cache = JM.init_cache(cfg, prompt.shape[0], max_len)
    step = jax.jit(lambda p, c, t, i: JM.decode_step(p, c, {"tokens": t}, i,
                                                     cfg))
    out = []
    for i in range(tokens):
        logits, cache = step(params, cache, tok, jnp.int32(i))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("impls", [("flash", "pallas"), ("auto", "auto")],
                         ids=["flash_vs_pallas", "auto"])
def test_greedy_tokens_match_jax(impls):
    cfgs = []
    for reg, impl in ((jreg, impls[1]), (treg, impls[0])):
        c = reg.get_smoke("qwen3-32b")
        cfgs.append(dataclasses.replace(
            c, param_dtype="float32",
            attention=dataclasses.replace(c.attention, impl=impl)))
    jcfg, tcfg = cfgs
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   tcfg, device="cpu")
    B, max_len, prompt_len, tokens = 2, 24, 16, 6
    res = tserve.serve(tcfg, B, max_len, prompt_len, tokens, device="cpu",
                       seed=5, params=tp)
    prompt = tserve.make_prompts(tcfg, B, prompt_len, seed=5)["tokens"]
    want = _jax_greedy(jcfg, jp, prompt, max_len, tokens)
    np.testing.assert_array_equal(res.tokens[0], want)
    assert res.peaks is None      # measured only on the card
    assert fa.launches == 0       # the CPU runs the plain version


def test_serve_requests_and_shapes():
    cfg = treg.get_smoke("starcoder2-3b")
    res = tserve.serve(cfg, 2, 16, 10, 3, device="cpu", requests=2)
    assert res.tokens.shape == (2, 2, 3)
    assert len(res.prefill_s) == len(res.decode_s) == 2
    assert tuple(res.prefill_logits[0].shape) == (2, 1, cfg.padded_vocab)
    assert torch.isfinite(res.prefill_logits[1].float()).all()
    with pytest.raises(ValueError):
        tserve.serve(cfg, 1, 8, 9, 1, device="cpu")


def test_pick_batch_gates_on_prefill_and_decode():
    cfg = treg.get_smoke("qwen3-32b")
    peaks = {}
    for b in (16, 1):
        _, gate = tserve.pick_batch(cfg, 64, capacity=1 << 62,
                                    candidates=(b,))
        peaks[b] = gate["candidates"][0]
        assert gate["peak"] == max(gate["prefill"].peak_bytes,
                                   gate["decode"].peak_bytes)
    # batch 16's decode step fits where its prefill does not: a
    # decode-only gate would admit it
    cap = max(peaks[16]["decode_peak"], peaks[1]["peak"])
    assert cap < peaks[16]["prefill_peak"]
    batch, gate = tserve.pick_batch(cfg, 64, capacity=cap,
                                    candidates=(16, 1))
    assert batch == 1 and gate["peak"] == peaks[1]["peak"]
    assert [c["fits"] for c in gate["candidates"]] == [False, True]
    batch, gate = tserve.pick_batch(cfg, 64, capacity=peaks[1]["peak"] - 1,
                                    candidates=(16, 1))
    assert batch is None and len(gate["candidates"]) == 2


def test_main_on_the_cpu(capsys):
    assert tserve.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device",
                        "cpu", "--max-len", "16", "--tokens", "2"]) == 0
    assert "serving batch=64" in capsys.readouterr().out


_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules if n in ("jax", "jaxlib")
             or n.startswith(("jax.", "jaxlib.", "repro.")) or n == "repro")
print("BAD", bad)
print("N", sum(n.startswith("repro_torch") for n in sys.modules))
print("HAVE", sorted(n for n in sys.modules if n.startswith("repro_torch.")))
"""

# the training, MoE, VLM/audio, baselines, sweep and admission-service
# slices' modules, which the walk above must have imported
_TRAINING_MODULES = (
    "repro_torch.service", "repro_torch.service.admission",
    "repro_torch.service.degrade", "repro_torch.service.faults",
    "repro_torch.service.store", "repro_torch.service.cluster",
    "repro_torch.launch.served", "repro_torch.launch.analytic",
    "repro_torch.obs.metrics", "repro_torch.obs.audit",
    "repro_torch.obs.ingest",
    "repro_torch.core.sweep", "repro_torch.launch.hillclimb",
    "repro_torch.obs.timeline",
    "repro_torch.core.analyzer", "repro_torch.core.cache",
    "repro_torch.core.metrics", "repro_torch.train.optimizer",
    "repro_torch.train.data", "repro_torch.train.train_step",
    "repro_torch.launch.train", "repro_torch.examples.quickstart",
    "repro_torch.models.moe", "repro_torch.train.checkpoint",
    "repro_torch.train.elastic", "repro_torch.core.baselines.common",
    "repro_torch.core.baselines.tensorsum",
    "repro_torch.core.baselines.dnnmem",
    "repro_torch.core.baselines.schedtune",
    "repro_torch.core.baselines.directprobe")


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True).stdout
    assert "BAD []" in out
    assert int(out.split("N ")[1].split()[0]) >= 28
    have = out.split("HAVE ")[1]
    assert all(repr(m) in have for m in _TRAINING_MODULES)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card exit; this machine has a card")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
