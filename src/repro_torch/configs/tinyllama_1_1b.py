"""Architecture config: tinyllama-1.1b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import ITAConfig, ModelConfig
from repro_torch.configs.common import PAR_SMALL

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="lm",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=64,
    d_ff=5632, vocab_size=32000,
    ita=ITAConfig(quantize_weights=True, split_brain=True),
    parallel=PAR_SMALL, source="hf:TinyLlama/TinyLlama-1.1B (paper Table IV)")
