"""Config registry of the port: the configurations its slices serve so far.

The split-brain main path runs the paper's own two models (Table IV):
TinyLlama-1.1B and Llama-2-7B.  The float ServeEngine also serves the other
dense lm configs (stablelm-1.6b, granite-8b, minitron-8b), gemma2-27b with
its alternating windowed and global layers, the attention-free RWKV6
family (rwkv6-7b), the hybrid attention + SSM family (hymba-1.5b), the
MoE members of the lm family (phi3.5-moe-42b-a6.6b, qwen3-moe-235b-a22b),
the lm family's cross-attention member (llama-3.2-vision-11b) and the
encoder-decoder family (seamless-m4t-medium); those two take a
``frontend`` of stub modality embeddings and are served through
``ServeEngine.generate()`` only.
"""
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import gemma2_27b as _gemma2_27b
from repro_torch.configs import granite_8b as _granite_8b
from repro_torch.configs import hymba_1_5b as _hymba_1_5b
from repro_torch.configs import llama2_7b as _llama2_7b
from repro_torch.configs import llama_3_2_vision_11b as _llama_3_2_vision_11b
from repro_torch.configs import minitron_8b as _minitron_8b
from repro_torch.configs import phi3_5_moe_42b_a6_6b as _phi3_5_moe_42b_a6_6b
from repro_torch.configs import qwen3_moe_235b_a22b as _qwen3_moe_235b_a22b
from repro_torch.configs import rwkv6_7b as _rwkv6_7b
from repro_torch.configs import seamless_m4t_medium as _seamless_m4t_medium
from repro_torch.configs import stablelm_1_6b as _stablelm_1_6b
from repro_torch.configs import tinyllama_1_1b as _tinyllama_1_1b

CONFIGS: Dict[str, ModelConfig] = {
    "tinyllama-1.1b": _tinyllama_1_1b.CONFIG,
    "llama2-7b": _llama2_7b.CONFIG,
    "rwkv6-7b": _rwkv6_7b.CONFIG,
    "stablelm-1.6b": _stablelm_1_6b.CONFIG,
    "minitron-8b": _minitron_8b.CONFIG,
    "gemma2-27b": _gemma2_27b.CONFIG,
    "granite-8b": _granite_8b.CONFIG,
    "hymba-1.5b": _hymba_1_5b.CONFIG,
    "phi3.5-moe-42b-a6.6b": _phi3_5_moe_42b_a6_6b.CONFIG,
    "qwen3-moe-235b-a22b": _qwen3_moe_235b_a22b.CONFIG,
    "llama-3.2-vision-11b": _llama_3_2_vision_11b.CONFIG,
    "seamless-m4t-medium": _seamless_m4t_medium.CONFIG,
}

# the ten configs of the dry run's sweep (``launch/dryrun.py --all``), in
# the JAX package's order
ASSIGNED = [
    "phi3.5-moe-42b-a6.6b",
    "qwen3-moe-235b-a22b",
    "stablelm-1.6b",
    "minitron-8b",
    "gemma2-27b",
    "granite-8b",
    "seamless-m4t-medium",
    "hymba-1.5b",
    "rwkv6-7b",
    "llama-3.2-vision-11b",
]


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
