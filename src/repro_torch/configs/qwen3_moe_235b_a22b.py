"""Architecture config: qwen3-moe-235b-a22b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="lm",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=64,
    d_ff=1536, vocab_size=151936, moe=MoEConfig(num_experts=128, top_k=8),
    parallel=PAR_BIG, source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)")
