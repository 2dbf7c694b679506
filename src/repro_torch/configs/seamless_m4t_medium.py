"""Architecture config: seamless-m4t-medium.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, num_encoder_layers=12, d_model=1024, num_heads=16,
    num_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=256206,
    frontend_tokens=960,  # precomputed audio-frame embeddings (stub frontend)
    parallel=PAR_BIG, source="arXiv:2308.11596")
