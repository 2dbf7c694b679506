"""Model API of the port: params, LAQ model quantization, and the bridge
that turns the JAX package's params (as numpy) into the port's."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.models import transformer


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    return transformer.init_params(cfg, generator, device=device)


# ----------------------------------------------------------------------------
# LAQ quantization of a whole model (the ITA "synthesis" step)
# ----------------------------------------------------------------------------
_QUANT_KEYS = {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "lm_head",
               "wr", "wg", "cm_k", "cm_v", "w_in", "w_out"}


def quantize_model(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Replace every device-side (static linear) weight with LAQ INT4 codes.

    Norm scales and embeddings stay in float.  Stacked (layer-leading)
    weights are quantized one (K, N) matrix at a time, on the weights'
    device, so at full width no more than one matrix's float temporaries
    exist at once; per-(layer, channel) scales are kept.
    """
    ita = cfg.ita

    def q2d(w):
        return quant.quantize_weights(
            w, prune_threshold=ita.prune_threshold, laq_slack=ita.laq_slack,
            logic_aware=ita.logic_aware)

    def quantize_entry(key: str, w):
        if key not in _QUANT_KEYS or not torch.is_tensor(w) or w.dim() < 2:
            return w
        if w.dim() == 2:
            return q2d(w)
        lead, (K, N) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
        flat = w.reshape((-1, K, N))
        codes = torch.empty((flat.shape[0], K, N), dtype=torch.int8,
                            device=w.device)
        scales = torch.empty((flat.shape[0], N), dtype=torch.float32,
                             device=w.device)
        for i in range(flat.shape[0]):
            ql = q2d(flat[i])
            codes[i] = ql.codes
            scales[i] = ql.scales
        return quant.QuantizedLinear(codes=codes.reshape(lead + (K, N)),
                                     scales=scales.reshape(lead + (N,)))

    def walk(node):
        if isinstance(node, dict):
            return {k: (walk(v) if isinstance(v, (dict, list))
                        else quantize_entry(k, v)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


# ----------------------------------------------------------------------------
# Bridge from the JAX package
# ----------------------------------------------------------------------------
def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: exact via float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Turn the JAX package's params into the port's, leaf for leaf.

    ``tree`` is ``jax.tree.map(np.asarray, params)``: float or quantized.
    A quantized leaf is recognised by its ``codes`` / ``scales`` attributes
    (no import of the JAX package) and becomes a
    :class:`~repro_torch.core.quant.QuantizedLinear`; arrays become tensors
    on ``device``; dict and list structure is kept."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if hasattr(tree, "codes") and hasattr(tree, "scales"):
        return quant.QuantizedLinear(codes=_tensor(tree.codes, device),
                                     scales=_tensor(tree.scales, device))
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "__array__"):
        return _tensor(tree, device)
    return tree
