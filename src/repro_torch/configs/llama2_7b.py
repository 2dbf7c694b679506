"""Architecture config: llama2-7b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ITAConfig, ModelConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="llama2-7b", family="lm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=32000,
    ita=ITAConfig(quantize_weights=True, split_brain=True),
    parallel=PAR_BIG, source="arXiv:2307.09288 (paper §V-C)")
