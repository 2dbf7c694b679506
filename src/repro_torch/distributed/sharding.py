"""The sharding rules of the JAX package's ``distributed/sharding.py``, for
one process per shard: the serve rules of tensor-parallel serving and the
training rules of the ``(data, model)`` grid.

The JAX package maps each leaf's path to a ``PartitionSpec`` on a
``("data", "model")`` mesh; the port keeps its serve rules as they are and
returns, for each leaf, the dim that the tensor-parallel group cuts (the
one that the spec puts on ``"model"``), or ``None`` where every rank holds
the whole leaf.  The copied rules:

  * params (:func:`param_cuts`): the column-only serve transform of
    ``_PARAM_RULES`` (``serve_param_pspecs``): ``wq`` / ``wk`` / ``wv`` /
    ``w1`` / ``w3`` and the recurrent projections of ``_COL`` cut on their
    output dim, ``lm_head`` / ``head`` on the vocabulary; the row-parallel
    weights (``wo``, ``w2``, ``_ROW``), ``embed``, ``A_log`` and the norms
    whole on every rank.  A QuantizedLinear's codes cut like its weight and
    its per-channel scales on their last dim.  The split-brain engine
    takes the same column-only cut: the JAX package gives it the full
    Megatron row cuts, whose exact cross-rank sum would need the W4A8
    kernel's int32 partial sums; a column block of the kernel's output is
    bit-identical to the full product's columns;
  * slot caches (:func:`serve_cache_cuts`, ``_SERVE_CACHE_RULES``): K/V on
    their KV-head dim, rwkv's WKV state on heads, its token-shift carries
    and hymba's SSM state on channels; under the sequence-cut dense decode
    (``parallel.decode_attn="shard_map"``, :func:`seq_group`) the K/V
    leaves that the family names instead on their sequence dim, as the JAX
    package's ``distributed_decode_attention`` takes them (its cache rules
    keep heads, and the ``shard_map`` reshards at each step; a rank here
    keeps its block of positions);
  * page pools (:func:`pool_cuts`, ``_POOL_CACHE_RULES``): a paging leaf
    ``(..., num_pages, page_size, Hkv, hd)`` on Hkv, a quantized pool's
    per-page scales on their Hkv dim; :func:`pool_kv_cut` is the pool's
    effective head cut.

The engines allocate a rank's slot caches and pools from these cuts alone
(:func:`rank_zeros`), with one named exception: rwkv's token-shift carries
``x_tm`` / ``x_cm``, which the rules cut on channels, stay whole.

Every cut is shape-checked as ``_fit`` does: a dim that the group's size
does not divide stays whole, which is the Hkv < tp fallback.

:func:`shard` takes a rank's block of a leaf, and :func:`gather` is
``pin_tp_exact``: the all-gather of a column-cut activation, which moves
bits and adds nothing.

Training (``param_pspecs``, ``batch_pspecs``, ``logits_pspec``):
:func:`train_param_cuts` gives each leaf ``(the dim on "model", the dim on
"data")`` under ``_PARAM_RULES`` as they are (the Megatron column and row
cuts, ``embed`` on the vocabulary, the MoE experts on "model"), ``fsdp``
resolved to "data" only where ``cfg.parallel.fsdp_axis`` names it (ZeRO-3),
each axis shape-checked on its own as ``_fit`` does (an axis of one rank
places its dim too, as in the reference), with the reference's key
rewriting for QuantizedLinear leaves and AdamW moment trees (``m/``,
``v/``, an int8 moment's ``q`` / ``scale``).  :func:`batch_cuts` and
:func:`logits_cut` are the batch's and the logits' cuts.
:class:`Layout` binds a config's cuts to a :class:`~repro_torch.
distributed.runtime.Grid`: a rank's block of a leaf (:meth:`Layout.block`,
the model cut then the data cut), the whole leaf back
(:meth:`Layout.gather_whole`), a rank's batch rows, and
:meth:`Layout.gather_fsdp`, the ZeRO-3 weight gather (``gather_fsdp``):
an all-gather over "data" whose backward is the reduce-scatter of the
gradients (``collectives.gather_sum``).  The reference keeps the MoE
expert stacks FSDP-cut at use, for GSPMD's contraction-parallel dots; an
eager rank cannot contract over rows it does not hold, so the port gathers
them like every other leaf (the values are the same).  :func:`pin_batch` is
a no-op: each rank holds only its batch rows.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.quant import QuantizedLeaf, QuantizedLinear
from repro_torch.distributed import collectives
from repro_torch.distributed.runtime import Grid, TPGroup, size_of

# param-name -> logical spec on the trailing dims, as in the JAX package
_COL = ("fsdp", "model")     # (d_in, out): out split over TP
_ROW = ("model", "fsdp")     # (in, d_out): in split over TP
_PARAM_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    (r".*moe/w[13]$", ("expert", "fsdp", None)),
    (r".*moe/w2$", ("expert", None, "fsdp")),
    (r".*moe/router$", ("fsdp", None)),
    (r".*/(wq|wk|wv|w1|w3|cm_k|w_in|w_delta|wg|wr|w_lora_a|w_B|w_C)$", _COL),
    (r".*/(wo|w2|cm_v|w_out|w_delta_up|w_lora_b)$", _ROW),
    (r".*/A_log$", ("model", None)),
    (r"^embed$", ("model", "fsdp")),
    (r"^lm_head$", ("fsdp", "model")),
    (r"(^|.*/)head$", ("fsdp", "model")),
    (r".*/u$", (None, None)),
)

_SERVE_CACHE_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    (r".*(^|/)(k|v|cross_k|cross_v)(/\d+)?$", ("batch", "model", None, None)),
    (r".*wkv$", ("batch", "model", None, None)),      # rwkv state (L,B,H,D,D)
    (r".*x_(tm|cm)$", ("batch", "model")),             # rwkv shift state (L,B,d)
    (r".*ssm$", ("batch", "model", None)),             # hymba ssm (L,B,d,N)
    (r".*len$", ("batch",)),
)

_POOL_CACHE_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    (r".*(^|/)(k|v|cross_k|cross_v)(/\d+)?$", (None, None, "model", None)),
)


def _match(rules, key: str):
    for pattern, spec in rules:
        if re.match(pattern, key):
            return spec
    return None


def _fit(spec_tail, shape, tp: int) -> Optional[int]:
    """The dim of ``shape`` that ``spec_tail`` (padded on the left to the
    rank of ``shape``) puts on "model", if ``tp`` divides it; else None.
    The group has no other axis: "batch", "fsdp" and "seq" place nothing."""
    ndim = len(shape)
    tail = list(spec_tail[-ndim:]) if len(spec_tail) > ndim else list(spec_tail)
    full = [None] * (ndim - len(tail)) + tail
    for i, (dim, logical) in enumerate(zip(shape, full)):
        if logical in ("model", "expert") and tp > 1 and dim % tp == 0:
            return i
    return None


def _column_only(spec):
    """The serve transform: "model" survives only on the last dim."""
    last = len(spec) - 1
    return tuple(None if (s in ("model", "expert") and i != last) else s
                 for i, s in enumerate(spec))


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict / list tree, keeping its
    structure; a path joins keys and list indices with "/"."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def param_cuts(params, tp: int):
    """Per leaf of a params tree (float tensors or QuantizedLinear), the dim
    that ``tp`` ranks cut under the column-only serve rules, or None; a
    QuantizedLinear gets ``(codes dim, scales dim)``.  Leaves without a
    shape (the TP group itself) stay whole."""
    def cut(path, leaf):
        spec = _match(_PARAM_RULES, path)
        if isinstance(leaf, QuantizedLinear):
            if spec is None:
                return (None, None)
            spec = _column_only(spec)
            return (_fit(spec, leaf.codes.shape, tp),
                    _fit(spec[-1:], leaf.scales.shape, tp))
        if spec is None or not hasattr(leaf, "shape"):
            return None
        return _fit(_column_only(spec), leaf.shape, tp)

    return _map_paths(cut, params)


def lse_decode(cfg) -> bool:
    """Whether the dense decode takes the JAX package's log-sum-exp body
    (``collectives.distributed_decode_attention``):
    ``parallel.decode_attn`` is ``"shard_map"`` with a sequence axis, where
    the reference's decode steps pass ``dist_axis``.  It does so on a mesh
    of one device too."""
    return (cfg.parallel.decode_attn == "shard_map"
            and cfg.parallel.seq_axis is not None)


def seq_group(cfg, tp: Optional[TPGroup]) -> Optional[TPGroup]:
    """The group over which a dense K/V cache is cut on its sequence: ``tp``
    (more than one rank) under :func:`lse_decode` with the model axis as
    the sequence axis, the axis the JAX package's
    ``distributed_decode_attention`` then cuts the sequence over; else None
    (the caches keep the head cut)."""
    par = cfg.parallel
    if (size_of(tp) > 1 and lse_decode(cfg)
            and par.seq_axis == par.model_axis):
        return tp
    return None


def serve_cache_cuts(cache, tp: int, seq: Sequence[str] = ()):
    """Per leaf of a dense serve cache, the dim that ``tp`` ranks cut under
    the serve cache rules (``serve_cache_pspecs``), or None.  A leaf named
    in ``seq`` (its top-level key) is cut on its sequence dim, the one
    before last, instead, which ``tp`` must divide."""
    def cut(path, leaf):
        if tp > 1 and path.split("/")[0] in seq:
            dim = leaf.dim() - 2
            if leaf.shape[dim] % tp:
                raise ValueError(
                    f"cache leaf {path!r}: a sequence of {leaf.shape[dim]} "
                    f"positions does not divide over {tp} ranks "
                    f"(parallel.decode_attn='shard_map' cuts it)")
            return dim
        spec = _match(_SERVE_CACHE_RULES, path)
        return None if spec is None else _fit(spec, leaf.shape, tp)

    return _map_paths(cut, cache)


def pool_cuts(pool, seq_axes, tp: int):
    """Per leaf of a paged slot cache (``serve/pages.py::make_pool``), the
    cut dim (``pool_pspecs``): a paging leaf (its ``seq_axes`` entry >= 0)
    takes the pool rule, its KV-head dim, and a QuantizedLeaf gets ``(codes
    dim, scales dim)`` with the scales cut on their own Hkv dim (the last);
    every other leaf takes the serve cache rules."""
    def cut(path, leaf):
        name = path.split("/")[0]
        axes = seq_axes[name]
        s_ax = axes[int(path.split("/")[1])] if isinstance(axes, list) else axes
        paged = s_ax >= 0
        spec = _match(_POOL_CACHE_RULES if paged else _SERVE_CACHE_RULES, path)
        if isinstance(leaf, QuantizedLeaf):
            if spec is None:
                return (None, None)
            return (_fit(spec, leaf.codes.shape, tp),
                    _fit((None, "model"), leaf.scales.shape, tp))
        return None if spec is None else _fit(spec, leaf.shape, tp)

    return _map_paths(cut, pool)


def pool_kv_cut(cuts, seq_axes, tp: int) -> int:
    """The pool's effective KV-head cut: ``tp`` when every paging leaf is cut
    (codes and scales of a quantized one), else 1: a whole leaf would break
    the per-shard byte accounting."""
    if tp <= 1:
        return 1
    flags = []
    for name, axes in seq_axes.items():
        entry = cuts[name]
        leaves = entry if isinstance(entry, list) else [entry]
        axes = axes if isinstance(axes, list) else [axes] * len(leaves)
        for c, s_ax in zip(leaves, axes):
            if s_ax >= 0:
                flags.append(all(d is not None for d in c)
                             if isinstance(c, tuple) else c is not None)
    return tp if all(flags) else 1


# Leaves that every rank keeps whole though the serve cache rules cut them:
# rwkv's token-shift carries are the whole pre-normed inputs of the next
# step's token mix, so a cut would only force a gather there (storage, not
# arithmetic)
_HELD_WHOLE = r"(^|.*/)x_(tm|cm)$"


def rank_zeros(like, cuts, tp: Optional[TPGroup], device):
    """A rank's zeroed state: every leaf of ``like`` (a tree of tensors --
    ``meta`` ones are fine -- or QuantizedLeafs, at the whole shapes) with
    the dim that ``cuts`` names for it (:func:`serve_cache_cuts` or
    :func:`pool_cuts` of ``like``) divided by the group's size, except the
    leaves held whole (``_HELD_WHOLE``); on ``device``.  This is the one
    place where a rank's cache and pool layouts are decided."""
    n = size_of(tp)
    flat = {}
    _map_paths(lambda path, c: flat.__setitem__(path, c), cuts)

    def zeros(t, dim):
        shape = list(t.shape)
        if dim is not None:
            shape[dim] //= n
        return torch.zeros(shape, dtype=t.dtype, device=device)

    def alloc(path, leaf):
        dim = None if re.match(_HELD_WHOLE, path) else flat[path]
        if isinstance(leaf, QuantizedLeaf):
            codes, scales = dim or (None, None)
            return QuantizedLeaf(zeros(leaf.codes, codes),
                                 zeros(leaf.scales, scales), leaf.kv_dtype,
                                 leaf.out_dtype)
        return zeros(leaf, dim)

    return _map_paths(alloc, like)


def rank_cache(like, tp: Optional[TPGroup], device, seq: Sequence[str] = ()):
    """This rank's zeroed dense serve cache: the whole cache's shapes
    ``like`` cut by the serve cache rules, the leaves named in ``seq`` on
    their sequence (:func:`rank_zeros`)."""
    return rank_zeros(like, serve_cache_cuts(like, size_of(tp), seq), tp,
                      device)


def seq_to_heads(x: torch.Tensor, tp: TPGroup, cut: bool) -> torch.Tensor:
    """A K/V leaf ``(..., Hkv, S/tp, D)`` cut on its sequence as the rank's
    head layout: every rank's block of positions gathered (an all-gather,
    which moves bits), then, where ``cut``, the rank's block of KV heads."""
    whole = torch.cat(tp.all_gather(x), dim=x.dim() - 2)
    return shard(whole, x.dim() - 3, tp) if cut else whole


def heads_to_seq(x: torch.Tensor, tp: TPGroup, cut: bool) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`: a leaf in the rank's head layout
    (its block of KV heads where ``cut``, else every head) as the rank's
    block of positions over every head."""
    whole = torch.cat(tp.all_gather(x), dim=x.dim() - 3) if cut else x
    return shard(whole, x.dim() - 2, tp)


# ----------------------------------------------------------------------------
# Cutting and gathering
# ----------------------------------------------------------------------------
def shard(t: torch.Tensor, dim: Optional[int], tp: Optional[TPGroup]
          ) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (contiguous, its own memory),
    or ``t`` itself where ``dim`` is None or the group is one rank."""
    n = size_of(tp)
    if dim is None or n == 1:
        return t
    w = t.shape[dim] // n
    return t.narrow(dim, tp.rank * w, w).contiguous()


def shard_params(params, tp: Optional[TPGroup]):
    """This rank's shard of a params tree under :func:`param_cuts` (the
    tree as it is for one rank).  A QuantizedLinear is cut unpacked; its
    packed codes are made from the block afterwards."""
    n = size_of(tp)
    if n == 1:
        return params
    cuts = param_cuts(params, n)

    def cut(leaf, c):
        if isinstance(leaf, QuantizedLinear):
            return QuantizedLinear(shard(leaf.codes, c[0], tp),
                                   shard(leaf.scales, c[1], tp))
        if isinstance(leaf, dict):
            return {k: cut(v, c[k]) for k, v in leaf.items()}
        return shard(leaf, c, tp) if torch.is_tensor(leaf) else leaf

    return cut(params, cuts)


def local_width(width: int, tp: Optional[TPGroup]) -> int:
    """A dim of ``width`` as a rank holds it: ``width / tp`` where the group
    cuts it (the group's size divides it), else whole."""
    n = size_of(tp)
    return width // n if n > 1 and width % n == 0 else width


def head_cut(tp: Optional[TPGroup], *heads: int) -> bool:
    """True when every count of ``heads`` divides by the group's size (more
    than one rank): the ranks then hold contiguous blocks of heads, and a
    block of query heads attends only the block of KV heads its column
    cuts produced."""
    n = size_of(tp)
    return n > 1 and all(h % n == 0 for h in heads)


def gather(x: torch.Tensor, tp: Optional[TPGroup], width: int,
           dim: int = -1) -> torch.Tensor:
    """``pin_tp_exact``: the whole of a column-cut activation ``x`` along
    ``dim`` (``width`` wide in all), every rank's block concatenated in
    rank order -- an all-gather, which moves bits and adds nothing.  ``x``
    already ``width`` wide (a whole weight's output, or one rank) is
    returned as it is."""
    if tp is None or tp.size == 1 or x.shape[dim] == width:
        return x
    return torch.cat(tp.all_gather(x), dim=dim)


def gather_heads(tp: Optional[TPGroup], *xs: torch.Tensor,
                 widths: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """:func:`gather` of several activations cut on their heads (dim 1), in
    one all-gather: each ``x`` whole, ``widths`` its whole head counts.
    Those already whole (one rank, or a head count the group does not
    divide) come back as they are."""
    if size_of(tp) == 1 or all(x.shape[1] == w for x, w in zip(xs, widths)):
        return xs
    parts = tp.all_gather(torch.cat(xs, dim=1))
    out, off = [], 0
    for x in xs:
        n = x.shape[1]
        out.append(torch.cat([p.narrow(1, off, n) for p in parts], dim=1))
        off += n
    return tuple(out)


# ----------------------------------------------------------------------------
# Training rules: (model dim, data dim) per leaf
# ----------------------------------------------------------------------------
def _train_fit(spec_tail, shape, dp: int, tp: int, fsdp: bool
               ) -> Tuple[Optional[int], Optional[int]]:
    """``_fit`` on the grid: the dims of ``shape`` that ``spec_tail``
    (padded on the left) puts on "model" and on "data", each only where
    that axis's size divides the dim (a size of 1 divides every dim)."""
    ndim = len(shape)
    tail = list(spec_tail[-ndim:]) if len(spec_tail) > ndim else list(spec_tail)
    full = [None] * (ndim - len(tail)) + tail
    model = data = None
    for i, (dim, logical) in enumerate(zip(shape, full)):
        if logical in ("model", "expert") and dim % tp == 0:
            model = i
        elif ((logical == "fsdp" and fsdp) or logical == "batch") \
                and dim % dp == 0:
            data = i
    return model, data


def _rule_key(path: str) -> Tuple[str, bool]:
    """The reference's key rewriting: a QuantizedLinear's ``codes`` cut as
    its weight and its ``scales`` on the out dim; a moment tree's ``m/`` /
    ``v/`` prefix and an int8 moment's ``q`` / ``scale`` dropped."""
    key = re.sub(r"/(codes)$", "", path)
    is_scales = key.endswith("/scales")
    key = re.sub(r"/scales$", "", key)
    key = re.sub(r"^(m|v)/", "", key)
    key = re.sub(r"/(q|scale)$", "", key)
    return key, is_scales


def train_param_cuts(tree, dp: int, tp: int, cfg):
    """Per leaf of ``tree`` (params -- float or QuantizedLinear --, a moment
    tree mirroring them, or ``{"step", "m", "v"}``): ``(model dim, data
    dim)`` under ``_PARAM_RULES`` on a ``(dp, tp)`` grid (``param_pspecs``);
    an int8 moment gets a ``QMoment`` of its two leaves' cuts, a
    QuantizedLinear a ``(codes, scales)`` pair of them.  A leaf no rule
    matches, or without a shape, is ``(None, None)``."""
    from repro_torch.train.optimizer import QMoment
    fsdp = cfg.parallel.fsdp_axis == "data"

    def cut(path, leaf):
        key, is_scales = _rule_key(path)
        spec = _match(_PARAM_RULES, key)
        if spec is None or not hasattr(leaf, "shape"):
            return (None, None)
        if is_scales:
            spec = spec[-1:]
        return _train_fit(spec, tuple(leaf.shape), dp, tp, fsdp)

    def leaf_cut(path, leaf):
        if isinstance(leaf, QMoment):
            return QMoment(cut(path + "/q", leaf.q),
                           cut(path + "/scale", leaf.scale))
        if isinstance(leaf, QuantizedLinear):
            return (cut(path + "/codes", leaf.codes),
                    cut(path + "/scales", leaf.scales))
        return cut(path, leaf)

    return _map_paths(leaf_cut, tree)


def batch_cuts(cfg, dp: int, tp: int, kind: str):
    """``batch_pspecs``: per batch entry the dim cut over "data" (the rows)."""
    keys = ["tokens"] + (["labels", "mask"] if kind == "train" else [])
    if cfg.frontend_tokens:
        keys.append("frontend")
    return {k: 0 for k in keys}


def logits_cut(cfg, dp: int, tp: int, kind: str
               ) -> Tuple[Optional[int], Optional[int]]:
    """``logits_pspec``: (the dim on "data", the dim on "model") of the
    logits, (B, V) at decode and (B, T, V) otherwise: the rows, and the
    vocabulary where ``tp`` divides it."""
    v = (1 if kind == "decode" else 2) if cfg.vocab_size % tp == 0 else None
    return 0, v


def pin_batch(x: torch.Tensor, cfg=None) -> torch.Tensor:
    """The reference pins the residual stream's batch sharding so that
    GSPMD keeps the batch cut; a rank already holds only its rows."""
    return x


def flat_cuts(cuts):
    """``{path: (model dim, data dim)}`` of a cut tree, paths as
    ``train/optimizer.py::leaves`` writes them (an int8 moment's ``.q`` /
    ``.scale``)."""
    from repro_torch.train.optimizer import QMoment
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, QMoment):
            walk(node.q, path + (".q",))
            walk(node.scale, path + (".scale",))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node

    walk(cuts, ())
    return out


class Layout:
    """A config's training cuts on a grid: ``cuts`` is
    :func:`train_param_cuts` of the whole params, ``shapes`` their whole
    shapes by path (``models/api.py::train_layout`` builds both)."""

    def __init__(self, cfg, grid: Grid, cuts, shapes):
        self.cfg = cfg
        self.grid = grid
        self.cuts = cuts
        self.shapes = shapes

    # -- blocks ---------------------------------------------------------------
    def block(self, t: torch.Tensor, cut) -> torch.Tensor:
        """This rank's block of the whole leaf ``t`` under ``cut``: its
        model block, then its data block (contiguous)."""
        m, d = cut
        t = shard(t, m, self.grid.model)
        t = shard(t, d, self.grid.data)
        return t.contiguous()

    def gather_whole(self, t: torch.Tensor, cut) -> torch.Tensor:
        """The whole leaf from every rank's block (no gradient)."""
        m, d = cut
        if d is not None and self.grid.data.size > 1:
            t = torch.cat(self.grid.data.all_gather(t), dim=d)
        if m is not None and self.grid.model.size > 1:
            t = torch.cat(self.grid.model.all_gather(t), dim=m)
        return t

    def map(self, fn, tree, cuts):
        """``fn(leaf, cut)`` over ``tree`` and its cut tree."""
        from repro_torch.train.optimizer import QMoment
        if isinstance(tree, dict):
            return {k: self.map(fn, v, cuts[k]) for k, v in tree.items()}
        if isinstance(tree, QMoment):
            return QMoment(fn(tree.q, cuts.q), fn(tree.scale, cuts.scale))
        if isinstance(tree, list):
            return [self.map(fn, v, c) for v, c in zip(tree, cuts)]
        return fn(tree, cuts) if torch.is_tensor(tree) else tree

    def shard_tree(self, tree, cuts=None):
        """This rank's blocks of a whole tree (params by default)."""
        return self.map(self.block, tree, self.cuts if cuts is None else cuts)

    def gather_tree(self, tree, cuts=None):
        """The whole tree from every rank's blocks (every rank calls it)."""
        return self.map(self.gather_whole, tree,
                        self.cuts if cuts is None else cuts)

    def state_cuts(self, opt_state):
        """The cut tree of ``{"params", "opt"}``: float32 moments are cut as
        their params; int8 moments are held whole on every rank
        (``train/optimizer.py``)."""
        from repro_torch.train.optimizer import QMoment

        def moments(tree, cuts):
            if isinstance(tree, dict):
                return {k: moments(v, cuts[k]) for k, v in tree.items()}
            if isinstance(tree, QMoment):
                return QMoment((None, None), (None, None))
            return cuts

        return {"params": self.cuts,
                "opt": {"step": (None, None),
                        "m": moments(opt_state["m"], self.cuts),
                        "v": moments(opt_state["v"], self.cuts)}}

    # -- the forward ------------------------------------------------------------
    def gather_fsdp(self, tree, cuts, lead: int = 0, dtype=None):
        """ZeRO-3: every leaf of ``tree`` whole on "data", the model cut
        kept (``gather_fsdp``); ``cuts`` is the matching subtree of
        :attr:`cuts` and ``lead`` the leading layer dims that ``tree``'s
        leaves (per-layer views) lack.  The backward reduce-scatters the
        gradients over "data".  ``dtype``: the gathered leaves come back
        cast to it (for leaves whose every use casts them so)."""
        data = self.grid.data

        def gather(t, cut):
            d = cut[1]
            if d is None or d < lead:
                return t
            return collectives.gather_sum(t, data, d - lead, dtype)

        return self.map(gather, tree, cuts)

    def batch_rows(self, batch):
        """This data rank's rows of a global batch (a dict of arrays or
        tensors, rows first): ``batch_cuts``."""
        dp, r = self.grid.data.size, self.grid.data.rank
        out = {}
        for k, v in batch.items():
            B = v.shape[0]
            if B % dp:
                raise ValueError(f"batch of {B} rows on {dp} data ranks")
            out[k] = v[r * (B // dp):(r + 1) * (B // dp)]
        return out

    def flat_cuts(self):
        """``{path: cut}`` of the params (:func:`flat_cuts`)."""
        if not hasattr(self, "_flat"):
            self._flat = flat_cuts(self.cuts)
        return self._flat

    def owns(self, cut) -> bool:
        """True on the one rank of each replica set of a leaf: index 0 on
        every axis that does not cut it (the global norm counts each
        element once)."""
        m, d = cut
        return ((m is not None or self.grid.model.rank == 0)
                and (d is not None or self.grid.data.rank == 0))
