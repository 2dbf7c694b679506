"""Architecture config: llama-3.2-vision-11b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="lm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, cross_attn_every=5,
    frontend_tokens=1600,  # precomputed patch embeddings (stub frontend)
    parallel=PAR_BIG, source="hf:meta-llama/Llama-3.2-11B-Vision")
