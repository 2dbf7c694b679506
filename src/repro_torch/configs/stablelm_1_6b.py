"""Architecture config: stablelm-1.6b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.common import PAR_SMALL

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="lm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
    parallel=PAR_SMALL, source="hf:stabilityai/stablelm-2-1_6b")
