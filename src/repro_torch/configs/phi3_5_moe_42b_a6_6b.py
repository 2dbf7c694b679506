"""Architecture config: phi3.5-moe-42b-a6.6b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="lm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064, moe=MoEConfig(num_experts=16, top_k=2),
    parallel=PAR_BIG, source="hf:microsoft/Phi-3.5-MoE-instruct")
