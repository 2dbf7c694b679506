"""Config registry of the port: the configurations its slices serve so far.

The split-brain main path runs the paper's own two models (Table IV):
TinyLlama-1.1B and Llama-2-7B; the float ServeEngine also serves the
attention-free RWKV6 family (rwkv6-7b).  The other families' configs join
as their slices are ported.
"""
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import llama2_7b as _llama2_7b
from repro_torch.configs import rwkv6_7b as _rwkv6_7b
from repro_torch.configs import tinyllama_1_1b as _tinyllama_1_1b

CONFIGS: Dict[str, ModelConfig] = {
    "tinyllama-1.1b": _tinyllama_1_1b.CONFIG,
    "llama2-7b": _llama2_7b.CONFIG,
    "rwkv6-7b": _rwkv6_7b.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]
