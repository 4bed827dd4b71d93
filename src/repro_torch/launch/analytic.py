"""Analytic roofline terms (a copy of ``repro.launch.analytic`` over the
port's configs; it holds no chip constants).

The compute/memory roofline terms come from standard MFU-style
analytic accounting over the exact configs:

* FLOPs: (6 + 2*refwd)·N_active·tokens for training (refwd=1 under full
  remat), 2·N_active·tokens for prefill, 2·N_active·batch per decoded
  token — plus the attention quadratic term per attention layer
  (causal-halved; sliding-window layers use min(S, window)).
* HBM bytes: parameter traffic (microbatch-aware: every microbatch
  re-reads the parameters — the real cost of gradient accumulation),
  optimizer read+write, gradient write+read, activation traffic
  (write+read of materialized per-layer tensors; remat re-writes),
  KV-cache read for decode.

All terms are per device on the given mesh.
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeSpec


def _attention_flops(cfg: ModelConfig, S: int, tokens: int) -> float:
    """Quadratic attention FLOPs (fwd, causal) across the stack."""
    if cfg.family == "ssm":
        x = cfg.xlstm
        dv = cfg.d_model // cfg.n_heads
        dk = max(int(dv * x.qk_dim_factor), 8)
        # chunkwise mLSTM: per token, a [chunk] window of k/v
        return 2.0 * tokens * x.chunk * cfg.n_heads * (dk + dv) \
            * cfg.n_layers
    per_layer = []
    for i in range(cfg.n_layers):
        if cfg.family == "hybrid" and cfg.attention.attn_every \
                and i % cfg.attention.attn_every != 0:
            continue  # mamba layer: linear state term, negligible here
        win = S
        if cfg.attention.sliding_window and cfg.attention.global_every:
            if (i % cfg.attention.global_every) != \
                    cfg.attention.global_every - 1:
                win = min(S, cfg.attention.sliding_window)
        # 2 matmuls (QK^T, PV), causal halves the square
        per_layer.append(2.0 * tokens * min(win, S) * cfg.n_heads
                         * cfg.hd)
    return float(sum(per_layer))


def analytic_flops(cfg: ModelConfig, shape: ShapeSpec, *,
                   remat_refwd: bool = True) -> float:
    """Global FLOPs for one step of this cell."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        mult = 6.0 + (2.0 if remat_refwd else 0.0)
        body = mult * n_act * shape.tokens
        attn = _attention_flops(cfg, shape.seq_len, shape.tokens) \
            * (4.0 if remat_refwd else 3.0)
        return body + attn
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.tokens \
            + _attention_flops(cfg, shape.seq_len, shape.tokens)
    # decode: one token per sequence against a seq_len cache
    flops = 2.0 * n_act * shape.global_batch
    if cfg.family != "ssm":
        l_attn = cfg.n_layers
        if cfg.family == "hybrid" and cfg.attention.attn_every:
            l_attn = cfg.n_layers // cfg.attention.attn_every
        flops += 4.0 * shape.global_batch * shape.seq_len * cfg.n_heads \
            * cfg.hd * l_attn
    return flops


def analytic_bytes(cfg: ModelConfig, shape: ShapeSpec, *,
                   n_devices: int, model_shards: int, fsdp_shards: int,
                   microbatches: int = 1, opt_state_mult: float = 2.0,
                   act_tensors_per_layer: float = 14.0,
                   act_passes: float = 3.0) -> float:
    """Per-device HBM traffic (bytes) for one step.

    ``act_passes`` is the number of HBM passes over the materialized
    activations: 3.0 under full remat (write + refwd rewrite + read),
    2.0 with no remat (write + read) — the remediation planner's cost
    model varies it per ``cfg.remat`` candidate."""
    dtype_b = cfg.dtype.itemsize
    p_dev = cfg.param_count() * dtype_b / (model_shards * fsdp_shards)
    dp = max(n_devices // model_shards, 1)
    tokens_dev = shape.tokens / dp if shape.kind != "decode" \
        else shape.global_batch / dp
    if shape.kind == "train":
        # fwd + remat-refwd + bwd parameter reads, per microbatch
        param_traffic = 3.0 * p_dev * microbatches
        opt_b = cfg.param_count() * 4.0 * opt_state_mult \
            / (model_shards * fsdp_shards)
        opt_traffic = 2.0 * opt_b + 3.0 * p_dev  # read+write opt, rw grads
        # activations: materialized tensors written+read (+refwd rewrite)
        act = tokens_dev * cfg.d_model * dtype_b \
            * act_tensors_per_layer * cfg.n_layers * act_passes \
            / microbatches \
            * microbatches  # per-microbatch traffic sums back to total
        return param_traffic + opt_traffic + act
    if shape.kind == "prefill":
        act = tokens_dev * cfg.d_model * dtype_b \
            * act_tensors_per_layer * cfg.n_layers
        return p_dev + act
    # decode: read params once, read the whole cache, write one slot
    if cfg.family == "ssm":
        x = cfg.xlstm
        dv = cfg.d_model // cfg.n_heads
        dk = max(int(dv * x.qk_dim_factor), 8)
        cache_dev = (shape.global_batch / dp) * cfg.n_heads * dk * dv \
            * 4.0 * cfg.n_layers
    else:
        l_kv = cfg.n_layers
        if cfg.family == "hybrid" and cfg.attention.attn_every:
            l_kv = cfg.n_layers // cfg.attention.attn_every
        cache_global = (shape.global_batch * shape.seq_len
                        * cfg.n_kv_heads * cfg.hd * dtype_b * 2 * l_kv)
        cache_dev = cache_global / n_devices  # batch x context sharding
    return p_dev + 2.0 * cache_dev \
        + (shape.global_batch / dp) * cfg.d_model * dtype_b \
        * act_tensors_per_layer * cfg.n_layers


def analytic_peak_bytes(cfg: ModelConfig, shape: ShapeSpec, *,
                        microbatches: int = 1,
                        with_optimizer: bool = True,
                        opt_state_mult: float = 2.0,
                        act_tensors_per_layer: float = 14.0,
                        model_shards: int = 1,
                        fsdp_shards: int = 1) -> int:
    """Closed-form **upper bound** on the per-device peak (bytes).

    The degradation ladder's last rung: when replay and the
    decision log are both unavailable, the admission service answers
    from this bound with a widened safety margin. It deliberately
    over-counts — full activation materialization with NO remat credit,
    fp32 optimizer moments, grads coexisting with parameters, plus the
    logits/loss buffers — so a degraded admit stays OOM-safe; the cost
    is headroom, never correctness.
    """
    dtype_b = cfg.dtype.itemsize
    shards = model_shards * fsdp_shards
    params = cfg.param_count() * dtype_b / shards
    grads = params if shape.kind == "train" else 0.0
    opt = (cfg.param_count() * 4.0 * opt_state_mult / shards
           if with_optimizer and shape.kind == "train" else 0.0)
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.tokens / max(int(microbatches), 1)
    acts = tokens * cfg.d_model * dtype_b \
        * act_tensors_per_layer * cfg.n_layers
    # output head: logits + fp32 softmax/loss scratch
    logits = tokens * cfg.padded_vocab * (dtype_b + 4.0)
    inputs = shape.tokens * 4.0 * 2.0      # token ids + targets (int32)
    return int(params + grads + opt + acts + logits + inputs)
