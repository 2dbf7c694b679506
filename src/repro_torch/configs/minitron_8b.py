"""Architecture config: minitron-8b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="minitron-8b", family="lm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000,
    parallel=PAR_BIG, source="arXiv:2407.14679")
