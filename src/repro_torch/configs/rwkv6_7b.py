"""Architecture config: rwkv6-7b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536, supports_long_context=True,
    parallel=PAR_BIG, source="arXiv:2404.05892")
