"""Config schema: model architecture + parallelism + ITA feature flags.

Every assigned architecture is a ``ModelConfig`` instance in its own module
(``src/repro/configs/<arch>.py``) built from the exact figures in the
assignment; ``reduced()`` derives the CPU smoke-test version.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# One layer-pattern entry: attention window (None = global) — the pattern
# repeats over the depth, so gemma2's local/global alternation is
# ("local", "global") with a 4096 window on the local slots.


@dataclass(frozen=True)
class LayerSpec:
    window: Optional[int] = None   # sliding-window size; None = full attention


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_dim: int = 4              # depthwise conv width (not used on decode fast path)
    dt_rank: int = 64


@dataclass(frozen=True)
class ITAConfig:
    """The paper's technique as a first-class feature."""
    quantize_weights: bool = False    # LAQ W4A8 device projections
    split_brain: bool = False         # partition serve_step into device/host phases
    prune_threshold: float = 2.0 ** -6
    laq_slack: float = 0.35
    logic_aware: bool = True


@dataclass(frozen=True)
class ParallelConfig:
    # logical -> mesh-axis mapping; None = replicated on that logical axis
    batch_axes: Tuple[str, ...] = ("pod", "data")
    model_axis: str = "model"
    fsdp_axis: Optional[str] = None   # shard weights over this too (ZeRO-3)
    seq_axis: Optional[str] = None    # KV-cache sequence sharding for decode
    remat: str = "full"               # "none" | "full" | "dots"
    scan_layers: bool = True
    grad_compression: bool = False    # int8 all-reduce (shard_map)
    pipeline_stages: int = 1
    decode_attn: str = "xla"          # "shard_map" = LSE-combined flash decode (Perf H2)
    aligned_decode: bool = True       # lockstep decode -> scalar-index cache writes (Perf H2)
    gather_fsdp_weights: bool = False # ZeRO-3 per-layer weight gather (Perf H4)
    exact_tp: bool = False            # serve TP: all-gather before down-projections
                                      # so no float contraction is ever split
                                      # (greedy token identity, DESIGN.md §11)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # "lm" | "rwkv" | "hymba" | "encdec"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    softcap: Optional[float] = None            # gemma2 logit softcap
    final_softcap: Optional[float] = None      # gemma2 final-logit softcap
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # cross-attention (VLM / enc-dec)
    cross_attn_every: Optional[int] = None     # insert a cross block each N layers
    num_encoder_layers: int = 0                # enc-dec only
    frontend_tokens: int = 0                   # stub modality tokens (audio/vision)
    # numerics / execution
    rwkv_chunk: int = 0                # >0: chunked matmul-form WKV (Perf H1)
    ssm_scan: str = "sequential"       # "associative" = log-depth scan (Perf H5)
    dtype: str = "bfloat16"
    use_pallas: bool = False
    ita: ITAConfig = field(default_factory=ITAConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # notes for DESIGN/EXPERIMENTS (e.g. long_500k applicability)
    supports_long_context: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        attn = d * hd * self.num_heads + 2 * d * self.kv_dim + hd * self.num_heads * d
        if self.family == "rwkv":
            attn = 4 * d * d + d * d  # r,k,v,g,o (decay via small lora)
        if self.moe:
            ffn = 3 * d * ff * self.moe.num_experts + d * self.moe.num_experts
        else:
            ffn = 3 * d * ff
        if self.family == "hymba":
            ssm = self.ssm or SSMConfig()
            attn += 2 * d * (2 * ssm.state_dim) + d * ssm.dt_rank + ssm.dt_rank * d
        emb = V * d * (1 if self.tie_embeddings else 2)
        cross = 0
        if self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            cross = n_cross * (2 * d * hd * self.num_heads + 2 * d * self.kv_dim)
        enc = self.num_encoder_layers * (attn + (3 * d * ff)) if self.num_encoder_layers else 0
        return L * (attn + ffn) + emb + cross + enc

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only top-k experts count)."""
        if not self.moe:
            return self.param_count()
        dense_like = replace(self, moe=None)
        base = dense_like.param_count() - 3 * self.d_model * self.d_ff * self.num_layers
        active_ffn = 3 * self.d_model * self.d_ff * self.moe.top_k * self.num_layers
        return base + active_ffn

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=max(2, len(self.layer_pattern)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            frontend_tokens=min(self.frontend_tokens, 8),
            num_encoder_layers=2 if self.num_encoder_layers else 0,
        )
        if self.moe:
            small["moe"] = MoEConfig(num_experts=4, top_k=2)
        if self.ssm:
            small["ssm"] = SSMConfig(state_dim=8, dt_rank=8)
        if self.cross_attn_every:
            small["cross_attn_every"] = 2
            small["num_layers"] = 4
        if self.layer_pattern and len(self.layer_pattern) > 1:
            small["layer_pattern"] = tuple(
                LayerSpec(window=16 if s.window else None) for s in self.layer_pattern)
        elif self.layer_pattern[0].window:
            small["layer_pattern"] = (LayerSpec(window=16),)
        small.update(overrides)
        return replace(self, name=self.name + "-smoke", **small)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
