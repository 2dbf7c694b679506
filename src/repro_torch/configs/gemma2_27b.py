"""Architecture config: gemma2-27b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.configs.common import PAR_BIG

CONFIG = ModelConfig(
    name="gemma2-27b", family="lm",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000, tie_embeddings=True,
    layer_pattern=(LayerSpec(window=4096), LayerSpec(window=None)),
    softcap=50.0, final_softcap=30.0,
    parallel=PAR_BIG, source="arXiv:2408.00118")
