"""Decoder-only Llama-family LM params (the lm family's dense FFN members).

Params are plain dicts of tensors with the JAX package's layout: every
per-layer array has leading dims ``(n_groups, group_size, ...)`` from
:func:`group_layout`, so a params tree converted from the JAX package
(``models/api.py::params_from_numpy``) and one made here have the same
structure.  The forward pass of the split-brain slice lives in
``serve/splitbrain_engine.py``; the full-sequence forward, MoE, cross
attention and the other families come with their slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def group_layout(cfg: ModelConfig) -> Tuple[int, int]:
    P = len(cfg.layer_pattern)
    group_size = cfg.cross_attn_every if cfg.cross_attn_every else P
    assert cfg.num_layers % group_size == 0, (cfg.num_layers, group_size)
    assert group_size % P == 0, (group_size, P)
    return cfg.num_layers // group_size, group_size


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random float32 params drawn from ``generator`` on ``device``:
    normal(0, 0.02) embeddings, zero norm scales and uniform
    ``dense_init`` projections, as in the JAX package (whose random bits
    differ; tests convert the JAX package's params instead)."""
    if cfg.family != "lm" or cfg.moe or cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: only the dense lm family is ported so far")
    n_groups, group_size = group_layout(cfg)
    lead = (n_groups, group_size)
    hd = cfg.resolved_head_dim
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, device=device)
    f32 = torch.float32
    embed = torch.empty((cfg.vocab_size, d), dtype=f32, device=device)
    embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
    params: Dict[str, Any] = {
        "embed": embed,
        "blocks": {
            "ln_attn": torch.zeros(lead + (d,), dtype=f32, device=device),
            "ln_mlp": torch.zeros(lead + (d,), dtype=f32, device=device),
            "attn": L.attn_init(d, cfg.num_heads, cfg.num_kv_heads, hd,
                                generator, **kw),
            "mlp": {
                "w1": L.dense_init(d, f, generator, **kw),
                "w3": L.dense_init(d, f, generator, **kw),
                "w2": L.dense_init(f, d, generator, **kw),
            },
        },
        "ln_final": torch.zeros((d,), dtype=f32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(d, cfg.vocab_size, generator,
                                         device=device)
    return params
