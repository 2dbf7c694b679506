"""Architecture config: hymba-1.5b.

Exact figures from the assignment; see ``source=`` for provenance.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig
from repro_torch.configs.common import PAR_SMALL

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hymba",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001, ssm=SSMConfig(state_dim=16, dt_rank=64),
    layer_pattern=(LayerSpec(window=1024),),   # SWA; SSM heads carry global ctx
    supports_long_context=True,
    parallel=PAR_SMALL, source="arXiv:2411.13676")
