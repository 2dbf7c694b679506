"""Model API of the port: family dispatch (the lm, rwkv, hymba and encdec
families), params, the whole-sequence forward and the training loss, the
serve path (cache, prefill, decode), LAQ model quantization, and the bridge
that turns the JAX package's params and optimizer state (as numpy) into the
port's.

Distributed training (``layout=``, a ``distributed/sharding.py::Layout`` of
a ``(data, model)`` grid): ``params`` are a rank's blocks and the batch its
rows.  Every config of the registry trains on any grid the JAX package's
rules allow: none is refused.  The lm family gathers its FSDP blocks per
layer (``models/transformer.py``); the other families gather theirs whole
over "data" before the forward, keeping the model cut.  Over "model" every
family runs Megatron's column and row cuts (``forward(model=)`` of
``rwkv6``, ``hymba`` and ``encdec``), a MoE config's experts are cut over
it (expert parallelism), and a dim that the group's size does not divide
stays whole, as the reference's ``_fit`` keeps it, with every rank running
that part whole.  The cross-entropy over logits cut on the vocabulary
is the vocabulary-parallel one (``collectives.vocab_parallel_nll``: an
all-reduce max, sum of exps and label logit; no rank holds a whole row),
and the loss is the global batch's, ``all_reduce(sum(nll * mask)) /
all_reduce(sum(mask))`` over "data", as GSPMD computes it, the same on
every rank; each rank's gradient is its rows' part of it."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.distributed import collectives, sharding
from repro_torch.models import encdec, hymba, rwkv6, transformer
from repro_torch.train.optimizer import QMoment, leaves, map_params


_FAMILIES = {"lm": transformer, "rwkv": rwkv6, "hymba": hymba,
             "encdec": encdec}


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port has "
            f"{', '.join(sorted(_FAMILIES))})")
    return _FAMILIES[cfg.family]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", **kw) -> Dict[str, Any]:
    """The family's random params; ``kw`` goes to its ``init_params`` (the
    ``dtype`` of the lm and encdec families' projections)."""
    return family_module(cfg).init_params(cfg, generator, device=device,
                                          **kw)


def forward(params, tokens, cfg: ModelConfig, frontend=None, layout=None):
    """Whole-sequence logits: tokens (B, T) -> (logits (B, T, V) float32,
    aux: a MoE config's load-balancing loss summed over its layers, else
    0.0).  ``frontend`` (B, Tx, d): the stub modality embeddings of a VLM
    or encoder-decoder config, which need it.  ``layout``: a training
    grid's (module docstring); the logits are the rank's rows, and its
    vocabulary block where the lm head is cut."""
    kw = {} if frontend is None else {"frontend": frontend}
    if layout is not None:
        if cfg.family == "lm":
            return transformer.forward(params, tokens, cfg, layout=layout,
                                       **kw)
        params = layout.gather_fsdp(params, layout.cuts)
        kw["model"] = layout.grid.model
    return family_module(cfg).forward(params, tokens, cfg, **kw)


def check_grid(cfg: ModelConfig, shape) -> None:
    """Raise for a grid shape that is not ``(dp, tp)`` of positive sizes.
    No config is refused a grid: the JAX package trains every one on any
    ``(data, model)`` mesh, and so does the port (a dim that the group's
    size does not divide stays whole)."""
    shape = tuple(shape)
    if len(shape) != 2 or not all(isinstance(n, int) and n >= 1
                                  for n in shape):
        raise ValueError(f"{cfg.name}: a training grid is (dp, tp) of "
                         f"positive sizes, got {shape}")


def train_layout(cfg: ModelConfig, grid) -> sharding.Layout:
    """``cfg``'s training cuts on ``grid`` (a ``runtime.Grid``), from the
    whole params' shapes (meta tensors: nothing is allocated)."""
    check_grid(cfg, grid.shape)
    like = init_params(cfg, torch.Generator(), device="meta")
    dp, tp = grid.shape
    shapes = {k: tuple(t.shape) for k, t in leaves(like)}
    return sharding.Layout(cfg, grid, sharding.train_param_cuts(
        like, dp, tp, cfg), shapes)


def train_params_from_numpy(tree: Any, layout: sharding.Layout,
                            device="cuda") -> Any:
    """One rank's blocks of the JAX package's params (numpy, whole): each
    leaf cut by ``layout`` (:func:`params_from_numpy` of the rank's
    blocks; the whole tree never reaches ``device``)."""
    blocks = layout.shard_tree(params_from_numpy(tree, "cpu"))
    return map_params(lambda t: t.to(device), blocks)


def loss_fn(params, batch: Dict[str, Any], cfg: ModelConfig,
            aux_weight: float = 0.01, layout=None):
    """Next-token cross-entropy over ``forward``'s float32 logits, plus
    ``aux_weight`` times a MoE config's load-balancing ``aux``: (total, {
    "loss", "aux"}), scalar float32 tensors.  ``batch`` holds ``tokens`` and
    ``labels`` (B, T), an optional float ``mask`` (B, T) (the loss averages
    over its sum, at least 1) and a VLM's or encoder-decoder's
    ``frontend``.  The JAX package's ``api.loss_fn``; the log-softmax is
    ``torch.log_softmax`` (the max is shifted out, as
    ``jax.nn.log_softmax`` does, and its gradient is the same rule).

    ``layout``: on a training grid, ``batch`` is this rank's rows and the
    loss the global batch's (module docstring).  A MoE ``aux`` is computed
    alike on every data rank from the whole batch's routing, so its
    gradient is scaled by ``1 / dp``: the data ranks' gradients add up to
    one."""
    logits, aux = forward(params, batch["tokens"], cfg,
                          frontend=batch.get("frontend"), layout=layout)
    labels = batch["labels"].to(torch.int64)
    if layout is not None and logits.shape[-1] != cfg.vocab_size:
        nll = collectives.vocab_parallel_nll(logits, labels,
                                             layout.grid.model)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    if layout is None:
        loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
        return loss + aux_weight * aux, {"loss": loss, "aux": aux}
    data = layout.grid.data
    num = collectives.reduce_from(torch.sum(nll * mask), data)
    den = data.all_reduce(torch.sum(mask).detach().to(torch.float32).clone())
    loss = num / torch.clamp_min(den, 1.0)
    total = loss + aux_weight * collectives.scale_grad(aux, 1.0 / data.size)
    return total, {"loss": loss, "aux": aux}


# ----------------------------------------------------------------------------
# Serve path
# ----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, frontend=None,
               params=None, device="cuda", tp=None):
    """The family's zeroed serve cache; a VLM or encoder-decoder config
    given ``frontend`` (batch, Tx, d) and its serving ``params`` also holds
    the per-request cross K/V (the encoder runs here).

    ``tp`` (a ``TPGroup`` of more than one rank): the cache as this rank
    holds it.  The zeroed leaves are the whole cache's shapes cut by the
    serve cache rules (``sharding.rank_cache``, the one source of a rank's
    layout), and the cross K/V are projected by the rank's own blocks of
    the serving ``params`` (the family's ``cross_cache``), never projected
    whole and sliced.  Under the sequence-cut dense decode
    (``sharding.seq_group``) the leaves that the family names in its
    ``SEQ_CUT`` are cut on their sequence instead of their heads: a rank
    holds ``(..., Hkv, S / tp, hd)``, every KV head of its block of
    positions, and an ``S`` that tp does not divide is refused.
    ``generate()`` and the slot protocol both take their caches from
    here."""
    mod = family_module(cfg)
    kw = ({} if frontend is None
          else {"frontend": frontend, "params": params})
    if sharding.size_of(tp) == 1:
        return mod.init_cache(cfg, batch, max_len, device=device, **kw)
    like = mod.init_cache(cfg, batch, max_len, device=torch.device("meta"))
    seq = (getattr(mod, "SEQ_CUT", ())
           if sharding.seq_group(cfg, tp) is not None else ())
    cache = sharding.rank_cache(like, tp, device, seq)
    if frontend is not None and params is not None:
        cache.update(mod.cross_cache(params, frontend, cfg))
    return cache


def decode_step(params, cache, tokens, cfg: ModelConfig, *, write=None):
    return family_module(cfg).decode_step(params, cache, tokens, cfg,
                                          write=write)


def paged_decode_step(params, cache, table, tokens, cfg: ModelConfig, *,
                      write=None, seq_axes=None):
    """One decode step computed directly through the page pool (cache and
    table as ``serve/pages.py::make_pool`` and the pager lay them out).
    Families whose caches never page (rwkv) take the dense slot layout and
    never reach here."""
    mod = family_module(cfg)
    if not hasattr(mod, "paged_decode_step"):
        raise NotImplementedError(
            f"family {cfg.family!r} has no paged decode entry point; its "
            "caches should have fallen back to the dense slot layout")
    return mod.paged_decode_step(params, cache, table, tokens, cfg,
                                 write=write, seq_axes=seq_axes)


def prefill_bucketed(params, cache, tokens, true_len, cfg: ModelConfig):
    """Fill a fresh cache with the first ``true_len`` positions of a prompt:
    (logits at ``true_len - 1`` (B, V), the cache with ``len += true_len``),
    in place.  The port's engine passes the true prompt (``true_len`` =
    width): eager PyTorch compiles nothing per width, so it pads to no
    bucket.

    The lm family takes its block prefill when every cache leaf holds the
    prompt (one flash-attention launch per layer on the card).  Otherwise,
    as in the JAX package, the prompt goes through ``decode_step`` one token
    at a time -- the prefill of rwkv, hymba (whose SSM state must not see
    padding) and encdec (no block prefill) -- over the true length only, so
    padding never reaches the state."""
    mod = family_module(cfg)
    n = int(true_len)
    if hasattr(mod, "prefill") and mod.prefill_fits(
            cache, tokens.shape[1], cfg, params.get("tp")):
        # the block prefill writes positions 0..T-1: a fresh cache only
        assert int(cache["len"].max()) == 0, "prefill requires an empty cache"
        return mod.prefill(params, cache, tokens, cfg, true_len=n)
    logits = None
    for t in range(n):
        logits, cache = mod.decode_step(params, cache, tokens[:, t], cfg)
    return logits, cache


def prefill_chunk(params, cache, tokens, true_len, cfg: ModelConfig, *,
                  block: bool = True):
    """Advance a (possibly non-empty) cache by one right-padded prompt
    chunk, in place, from whatever state it holds: tokens (B, W), only the
    first ``true_len`` real.  Returns the cache with ``len += true_len``;
    no logits (the last prompt token goes through the decode step).

    ``block=True`` takes the lm family's block path
    (``transformer.prefill_chunk``), whose caller guarantees a linear cache
    and chunk-aligned start.  Otherwise, as in the JAX package, the chunk
    goes through ``decode_step`` one token at a time over its true length
    (the JAX package scans the padded width with the state frozen past
    ``true_len``: the same state), which every family takes: rwkv6's
    recurrent state, hymba's SSM state and rings, gemma2's rings."""
    mod = family_module(cfg)
    if block and hasattr(mod, "prefill_chunk"):
        return mod.prefill_chunk(params, cache, tokens, int(true_len), cfg)
    for t in range(int(true_len)):
        _, cache = mod.decode_step(params, cache, tokens[:, t], cfg)
    return cache


def prefill(params, cache, tokens, cfg: ModelConfig):
    """Fill a fresh cache with a whole prompt: tokens (B, T) -> (last
    position's logits (B, V), the cache with ``len += T``), in place."""
    return prefill_bucketed(params, cache, tokens, tokens.shape[1], cfg)


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
    exist at once; per-(layer, channel) scales are kept.  The W4A8
    kernel reads the codes packed (:func:`pack_model`, made once where
    the serving weights are built, after any tensor-parallel cut).  On
    ``meta`` (the dry run) the leaves are shapes only.
    """
    ita = cfg.ita

    def q2d(w):
        return quant.quantize_weights(
            w, prune_threshold=ita.prune_threshold, laq_slack=ita.laq_slack,
            logic_aware=ita.logic_aware)

    def quantize_entry(key: str, w):
        if key not in _QUANT_KEYS or not torch.is_tensor(w) or w.dim() < 2:
            return w
        if w.is_meta:                  # the dry run: shapes only
            return quant.QuantizedLinear(
                codes=torch.empty(w.shape, dtype=torch.int8, device=w.device),
                scales=torch.empty(w.shape[:-2] + w.shape[-1:],
                                   dtype=torch.float32, device=w.device))
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


def pack_model(tree):
    """Every QuantizedLinear of ``tree`` with its codes also packed for the
    W4A8 kernel (once; stacked layers in one call; a leaf already packed
    is kept)."""
    if isinstance(tree, dict):
        return {k: pack_model(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [pack_model(v) for v in tree]
    if isinstance(tree, quant.QuantizedLinear):
        return tree.with_packed()
    return tree


# ----------------------------------------------------------------------------
# Dry-run input specs (meta tensors; zero allocation)
# ----------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """Model inputs for one step of ``shape`` (a ``ShapeConfig``), as empty
    ``meta`` tensors: the JAX package's ``ShapeDtypeStruct`` specs, key for
    key.  ``tokens`` (B, T) int32 for train and prefill, with ``labels``
    (B, T) for train, or (B,) for decode (one new token against a T-long
    cache); ``frontend`` (B, frontend_tokens, d) in ``cfg.dtype`` for a
    config that takes one."""
    B, T = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = torch.empty((B, T), dtype=torch.int32, device=meta)
        if shape.kind == "train":
            specs["labels"] = torch.empty((B, T), dtype=torch.int32,
                                          device=meta)
    else:
        specs["tokens"] = torch.empty((B,), dtype=torch.int32, device=meta)
    if cfg.frontend_tokens:
        specs["frontend"] = torch.empty(
            (B, cfg.frontend_tokens, cfg.d_model),
            dtype=getattr(torch, cfg.dtype), device=meta)
    return specs


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
    on ``device``; dict and list structure is kept, so every family's
    layout carries over as it is (the lm family's ``(n_groups, group_size,
    ...)`` and a VLM's ``cross`` blocks' ``(n_groups, ...)``, encdec's
    ``(L, ...)``)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "codes") and hasattr(tree, "scales"):
        packed = getattr(tree, "packed", None)      # the port's own, if any
        return quant.QuantizedLinear(
            codes=_tensor(tree.codes, device),
            scales=_tensor(tree.scales, device),
            packed=None if packed is None else _tensor(packed, device))
    if isinstance(tree, (list, tuple)):
        return _rebuild_sequence(tree, (params_from_numpy(v, device)
                                        for v in tree))
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "__array__"):
        return _tensor(tree, device)
    return tree


def _rebuild_sequence(seq, items):
    """A list, tuple or NamedTuple of the same type holding ``items`` (a
    NamedTuple takes its fields as arguments, not one iterable)."""
    if hasattr(seq, "_fields"):
        return type(seq)(*items)
    return type(seq)(items)


def opt_state_from_numpy(state: Dict[str, Any], device="cuda"
                         ) -> Dict[str, Any]:
    """Turn the JAX package's AdamW state into the port's
    (``train/optimizer.py``), leaf for leaf.

    ``state`` is ``jax.tree.map(np.asarray, opt_state)``: ``step`` (an
    int32 scalar), and ``m`` / ``v`` mirroring the params, each moment a
    float32 array or an int8 moment ``_QMoment(q, scale)``, recognised by
    its ``q`` / ``scale`` fields (no import of the JAX package) and made an
    ``optimizer.QMoment``.  Arrays become tensors on ``device``."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QMoment(_tensor(node.q, device), _tensor(node.scale,
                                                            device))
        if isinstance(node, (list, tuple)):
            return _rebuild_sequence(node, (conv(v) for v in node))
        return _tensor(node, device)

    return {"step": _tensor(np.asarray(state["step"], np.int32), device),
            "m": conv(state["m"]), "v": conv(state["v"])}
