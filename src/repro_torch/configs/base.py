"""Model/shape configuration schema shared by the whole framework
(PyTorch port of ``repro.configs.base``: ``dtype`` is a torch dtype and
``AttentionConfig.impl`` names the Hopper kernel ``"flash"``).

One ``ModelConfig`` describes any architecture in the assigned pool
(dense / MoE / hybrid Mamba / xLSTM / VLM / audio). Each
``src/repro/configs/<arch>.py`` exports ``FULL`` (the exact published
config) and ``SMOKE`` (a reduced same-family config for CPU tests), plus
the standard shape grid.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    every_n_layers: int = 1      # 1 = every layer is MoE; 2 = alternate
    num_groups: int = 1          # dispatch groups (launcher sets = dp size)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model
    chunk: int = 256             # chunked-scan block size


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8         # 1 sLSTM per N blocks (rest mLSTM)
    chunk: int = 256
    qk_dim_factor: float = 0.5   # mLSTM k/q head dim = factor * v dim


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    sliding_window: int | None = None    # window size for local layers
    global_every: int | None = None      # 1 global layer per N (gemma3: 6)
    attn_every: int | None = None        # hybrid: 1 attn layer per N (jamba: 8)
    qk_norm: bool = False                # qwen3
    rope_theta: float = 10_000.0
    # §Perf knob: broadcast KV heads to full H inside attention so the
    # head dim shards cleanly on a TP axis that Hkv (2-8) doesn't divide;
    # costs a small per-chunk KV repeat, removes inner-loop collectives.
    repeat_kv_for_tp: bool = False
    chunk_q: int = 512                   # chunked-attention block sizes
    chunk_kv: int = 1024
    # use plain softmax below this S; above it the O(S^2) score tensor
    # (e.g. 68 GB/device for qwen3 at 4k) forces the chunked path
    dense_threshold: int = 2048
    # "flash" selects the hand-written Hopper kernel (the JAX package's
    # "pallas")
    impl: str = "auto"                   # auto|dense|chunked|flash


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    xlstm: XLSTMConfig | None = None
    attention: AttentionConfig = AttentionConfig()
    # modality frontends are STUBS: input_specs() yields precomputed
    # patch/frame embeddings (assignment requirement)
    num_patches: int = 0                 # vlm: image patch embeddings
    num_codebooks: int = 0               # audio: EnCodec codebooks
    tie_embeddings: bool = False
    # §Perf knob: pad embedding/head vocab up to a multiple (e.g. 16) so
    # the vocab dim shards on the model axis; non-divisible vocabs
    # (internvl2's 151655) otherwise replicate the [B,S,V] logits.
    pad_vocab_multiple: int | None = None
    param_dtype: str = "bfloat16"
    # training-time policies (overridable by the launcher)
    remat: str = "full"                  # full|dots|none
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        if self.pad_vocab_multiple:
            m = self.pad_vocab_multiple
            return ((self.vocab + m - 1) // m) * m
        return self.vocab

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    # ---- parameter counting (roofline MODEL_FLOPS = 6*N*D) -------------
    def _layer_param_counts(self) -> tuple[int, int]:
        """(total_per_layer_avg, active_per_layer_avg) over the stack."""
        d, hd = self.d_model, self.hd
        attn = d * (self.n_heads * hd) * 2 \
            + d * (self.n_kv_heads * hd) * 2          # q,o + k,v
        dense_ffn = 3 * d * self.d_ff                 # swiglu
        total = active = 0.0
        for i in range(self.n_layers):
            is_attn_layer = True
            if self.family == "hybrid" and self.attention.attn_every:
                is_attn_layer = (i % self.attention.attn_every == 0)
            if self.family == "ssm":
                x = self.xlstm or XLSTMConfig()
                d_in = d  # mLSTM internal projections ~4*d*d
                total += 4 * d * d_in + 2 * d_in * d
                active += 4 * d * d_in + 2 * d_in * d
                continue
            mix = attn
            if self.family == "hybrid" and not is_attn_layer:
                m = self.mamba or MambaConfig()
                d_inner = m.expand * d
                mix = 2 * d * d_inner + d_inner * d + d_inner * m.d_state * 2
            total += mix
            active += mix
            is_moe = (self.moe is not None
                      and i % self.moe.every_n_layers
                      == (self.moe.every_n_layers - 1))
            if is_moe:
                total += self.moe.num_experts * 3 * d * self.d_ff \
                    + d * self.moe.num_experts
                active += self.moe.top_k * 3 * d * self.d_ff \
                    + d * self.moe.num_experts
            elif self.d_ff:
                total += dense_ffn
                active += dense_ffn
            total += 2 * d  # norms
            active += 2 * d
        return int(total), int(active)

    def param_count(self) -> int:
        layers, _ = self._layer_param_counts()
        emb = self.vocab * self.d_model
        head = 0 if self.tie_embeddings else self.vocab * self.d_model
        if self.num_codebooks:
            emb = self.num_codebooks * self.vocab * self.d_model
            head = self.num_codebooks * self.vocab * self.d_model
        return layers + emb + head + self.d_model

    def active_param_count(self) -> int:
        _, active = self._layer_param_counts()
        emb = self.vocab * self.d_model
        head = 0 if self.tie_embeddings else self.vocab * self.d_model
        if self.num_codebooks:
            emb = self.num_codebooks * self.vocab * self.d_model
            head = self.num_codebooks * self.vocab * self.d_model
        return active + emb + head + self.d_model


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (seq_len x global_batch + step kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The assigned LM shape grid (identical for all 10 archs).
TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def smoke_shape(seq_len: int = 64, global_batch: int = 2,
                kind: str = "train") -> ShapeSpec:
    return ShapeSpec("smoke", seq_len, global_batch, kind)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6 * N(active) * D  (training); 2*N*D for inference."""
    n = cfg.active_param_count()
    d = shape.tokens if shape.kind == "train" else (
        shape.tokens if shape.kind == "prefill" else shape.global_batch)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n * d


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic families (DESIGN.md §4)."""
    return cfg.family in ("hybrid", "ssm")
