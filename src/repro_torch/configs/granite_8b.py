"""Architecture config: granite-8b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="granite-8b", family="lm",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152,
    parallel=PAR_BIG, source="arXiv:2405.04324")
