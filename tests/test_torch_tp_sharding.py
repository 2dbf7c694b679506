"""The port's serve sharding rules (``repro_torch/distributed/sharding.py``)
against the JAX package's ``serve_param_pspecs``, ``serve_cache_pspecs``,
``pool_pspecs`` and ``pool_kv_cut``, leaf by leaf, at tp 2 and 4 on an
``AbstractMesh`` (no devices needed), over the four slot-cache families of
``tests/test_sharding_serve.py`` built as that file builds them, with a
bf16 and an int8 pool, and over a MoE config (whose expert stacks and
router every rank holds whole) and the cross-attention configs (their
caches with a frontend's cross K/V).  The one intended difference is the split-brain
engine's layout: the port gives its stacked W4A8 weights the column-only
serve cut, where the JAX package gives them the Megatron row cuts
(``param_pspecs``) too."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P

from repro.configs import get_config
from repro.distributed import sharding as shd
from repro.models import api as japi
from repro.serve import pages as jpages
from repro.serve import slots as jslots
from repro.serve.splitbrain_engine import _stack_layers as j_stack_layers
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.quant import QuantizedLinear
from repro_torch.distributed import sharding
from repro_torch.models import api
from repro_torch.serve import pages
from repro_torch.serve.engine import ServeEngine

MAX_LEN, PS = 32, 8
FAMILIES = ["llama2-7b", "gemma2-27b", "hymba-1.5b", "rwkv6-7b",
            "phi3.5-moe-42b-a6.6b", "llama-3.2-vision-11b",
            "seamless-m4t-medium"]
TPS = [2, 4]


def tp_mesh(tp):
    # test_sharding_serve.py's ((name, size), ...) form is refused by this
    # JAX; the same mesh in its (sizes, names) form
    return AbstractMesh((1, tp), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2)


def _jax_cuts(spec_tree):
    """{path: the dim a PartitionSpec puts on "model", or None} over a JAX
    spec tree (a quantized leaf's codes and scales as two paths)."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in flat:
        dims = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        assert len(dims) <= 1, (path, spec)
        out[shd._path_str(path)] = dims[0] if dims else None
    return out


def _port_cuts(tree, prefix=""):
    """The same flattening of the port's cut tree: a QuantizedLinear's or
    QuantizedLeaf's (codes dim, scales dim) pair as two paths."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_cuts(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_port_cuts(v, f"{prefix}{i}/"))
    elif isinstance(tree, tuple):
        out[prefix + "codes"], out[prefix + "scales"] = tree
    else:
        out[prefix[:-1]] = tree
    return out


def _meta_tree(tree):
    """A JAX shape tree as the port's tree of meta tensors (a quantized
    leaf as a QuantizedLinear), the structure kept as
    ``api.params_from_numpy`` keeps it."""
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta_tree(v) for v in tree)
    if hasattr(tree, "codes"):
        return QuantizedLinear(_meta_tree(tree.codes), _meta_tree(tree.scales))
    return torch.empty(tree.shape, device="meta")


class _Group:
    """A stand-in for a TPGroup where only its size and rank are read."""

    def __init__(self, size, rank=0):
        self.size, self.rank = size, rank


@functools.lru_cache(maxsize=None)
def _build(name):
    cfg = get_config(name).reduced(vocab_size=128)
    params = jax.eval_shape(lambda: japi.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: japi.init_cache(cfg, 2, MAX_LEN))
    grown = jax.eval_shape(lambda: japi.init_cache(cfg, 2, MAX_LEN + PS))
    b1 = jax.eval_shape(lambda: japi.init_cache(cfg, 1, MAX_LEN))
    ba = jslots.batch_axes(b1, cache)
    sa = jpages.seq_axes(cache, grown, PS)
    tcfg = t_get_config(name).reduced(vocab_size=128)
    tparams = _meta_tree(params)
    meta = torch.device("meta")
    tcache = api.init_cache(tcfg, 2, MAX_LEN, device=meta)
    tsa = pages.seq_axes(tcache, api.init_cache(tcfg, 2, MAX_LEN + PS,
                                                device=meta), PS)
    tba = api.family_module(tcfg).BATCH_AXES
    if cfg.frontend_tokens:
        # the cut tests take a request's cache with its frontend's cross
        # K/V (each package's init_cache with a frontend and params)
        fe = (2, cfg.frontend_tokens, cfg.d_model)
        cache = jax.eval_shape(lambda: japi.init_cache(
            cfg, 2, MAX_LEN, frontend=jax.numpy.zeros(fe),
            params=japi.init_params(cfg, jax.random.PRNGKey(0))))
        real = api.init_cache(
            tcfg, 2, MAX_LEN, device="cpu", frontend=torch.zeros(fe),
            params=api.init_params(tcfg, torch.Generator().manual_seed(0),
                                   "cpu"))
        tcache = sharding._map_paths(
            lambda p, t: torch.empty(t.shape, dtype=t.dtype, device=meta),
            real)
    return dict(name=name, cfg=cfg, params=params, cache=cache, ba=ba, sa=sa,
                tcfg=tcfg, tparams=tparams, tcache=tcache, tsa=tsa, tba=tba)


@pytest.fixture(params=FAMILIES)
def family(request):
    return _build(request.param)


# the families whose K/V page at max_len 32 (hymba's and gemma2's local
# rings bind at the reduced window of 16; rwkv has no K/V)
@pytest.fixture(params=["llama2-7b", "gemma2-27b"])
def paged_family(request):
    return _build(request.param)


@pytest.mark.parametrize("tp", TPS)
def test_param_cuts_equal_serve_param_pspecs(family, tp):
    want = _jax_cuts(shd.serve_param_pspecs(family["params"], family["cfg"],
                                            tp_mesh(tp)))
    got = _port_cuts(sharding.param_cuts(family["tparams"], tp))
    assert got == want
    assert any(d is not None for d in got.values())


@pytest.mark.parametrize("tp", TPS)
def test_cache_cuts_equal_serve_cache_pspecs(family, tp):
    want = _jax_cuts(shd.serve_cache_pspecs(family["cache"], family["cfg"],
                                            tp_mesh(tp)))
    got = _port_cuts(sharding.serve_cache_cuts(family["tcache"], tp))
    assert got == want


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("tp", TPS)
def test_pool_cuts_and_kv_cut_equal_pool_pspecs(paged_family, tp, kv_dtype):
    s = paged_family
    assert any(ax >= 0 for ax in jax.tree.leaves(s["sa"]))
    pshape = jpages.pool_shape(s["cache"], s["ba"], s["sa"], num_pages=16,
                               page_size=PS, kv_dtype=kv_dtype)
    jspecs = shd.pool_pspecs(pshape, s["cfg"], tp_mesh(tp), s["sa"])
    pool = pages.make_pool(s["tcache"], s["tba"], s["tsa"], 16, PS,
                           torch.device("meta"), kv_dtype=kv_dtype)
    cuts = sharding.pool_cuts(pool, s["tsa"], tp)
    assert _port_cuts(cuts) == _jax_cuts(jspecs)
    assert (sharding.pool_kv_cut(cuts, s["tsa"], tp)
            == shd.pool_kv_cut(jspecs, s["sa"], tp, "model"))
    # the pool a rank allocates: the whole pool cut where JAX's specs cut it
    local, kv = pages.make_rank_pool(s["tcache"], s["tba"], s["tsa"], 16, PS,
                                     torch.device("meta"), kv_dtype,
                                     _Group(tp))
    assert kv == shd.pool_kv_cut(jspecs, s["sa"], tp, "model")
    assert _shapes(local) == _cut(_shapes(pool), _jax_cuts(jspecs), tp)


def _shapes(tree):
    """{path: shape} of a tree of tensors, a QuantizedLeaf's codes and
    scales as two paths (as :func:`_port_cuts` names them)."""
    out = {}

    def put(path, t):
        if hasattr(t, "codes"):
            out[path + "/codes"] = list(t.codes.shape)
            out[path + "/scales"] = list(t.scales.shape)
        else:
            out[path] = list(t.shape)

    sharding._map_paths(put, tree)
    return out


def _cut(shapes, cuts, tp):
    """``shapes`` with the dim that ``cuts`` names for each path divided by
    ``tp``."""
    out = {}
    for path, shape in shapes.items():
        out[path] = shape[:]
        if cuts[path] is not None:
            out[path][cuts[path]] //= tp
    return out


def test_engine_local_cache_shapes_follow_the_rules(family):
    """The dense cache that a rank of the engines allocates
    (``sharding.rank_cache`` of the whole cache's shapes) is the whole
    cache cut exactly where the JAX package's ``serve_cache_pspecs`` cut
    it, by the group's size, except rwkv's token-shift carries, which
    every rank keeps whole (a cut would only force a gather at the next
    step)."""
    s = family
    for tp in TPS:
        want = _jax_cuts(shd.serve_cache_pspecs(s["cache"], s["cfg"],
                                                tp_mesh(tp)))
        want = {p: None if p.startswith(("x_tm", "x_cm")) else d
                for p, d in want.items()}
        local = sharding.rank_cache(s["tcache"], _Group(tp),
                                    torch.device("meta"))
        assert (_shapes(local) == _cut(_shapes(s["tcache"]), want, tp)), \
            (s["name"], tp)


@pytest.mark.parametrize("tp", TPS)
def test_splitbrain_layout_is_column_only_by_design(tp):
    """The split-brain engine's stacked W4A8 tree: the port's cuts equal the
    JAX package's column-only ``serve_param_pspecs``; against the Megatron
    ``param_pspecs`` that the JAX engine uses for ``quantize=True`` they
    differ exactly where a row cut would split the contraction (``wo``,
    ``w2``): the port keeps those whole."""
    cfg = get_config("llama2-7b").reduced(vocab_size=128)

    def stacked():
        params = japi.init_params(cfg, jax.random.PRNGKey(1))
        dev = japi.quantize_model(params, cfg)
        return {"layers": {
            "attn": j_stack_layers(dev["blocks"]["attn"], cfg.num_layers),
            "mlp": j_stack_layers(dev["blocks"]["mlp"], cfg.num_layers),
            "ln_attn": j_stack_layers(params["blocks"]["ln_attn"],
                                      cfg.num_layers),
            "ln_mlp": j_stack_layers(params["blocks"]["ln_mlp"],
                                     cfg.num_layers)},
            "head": dev["lm_head"]}

    jtree = jax.eval_shape(stacked)
    ttree = _meta_tree(jtree)
    got = _port_cuts(sharding.param_cuts(ttree, tp))
    mesh = tp_mesh(tp)
    assert got == _jax_cuts(shd.serve_param_pspecs(jtree, cfg, mesh))
    megatron = _jax_cuts(shd.param_pspecs(jtree, cfg, mesh))
    differ = sorted(p for p in got if got[p] != megatron[p])
    assert differ == ["layers/attn/wo/codes", "layers/mlp/w2/codes"]
    assert all(got[p] is None and megatron[p] == 1 for p in differ)
    assert isinstance(ttree["layers"]["attn"]["wq"], QuantizedLinear)


def test_shard_and_gather_round_trip():
    """``shard`` takes the rank's contiguous block, and the concatenation of
    every rank's block (what ``gather`` all-gathers) is the whole."""
    t = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    for tp in (2, 4):
        blocks = [sharding.shard(t, 2, _Group(tp, r)) for r in range(tp)]
        assert all(b.is_contiguous() and b.shape == (2, 3, 8 // tp)
                   for b in blocks)
        assert torch.equal(torch.cat(blocks, dim=-1), t)
    assert sharding.shard(t, None, _Group(2)) is t
    assert sharding.gather(t, None, 99) is t
    assert sharding.gather(t, _Group(2), 8) is t
    assert sharding.local_width(6, _Group(4)) == 6
    assert sharding.head_cut(_Group(2), 4, 2)
    assert not sharding.head_cut(_Group(4), 4, 2)
    assert not sharding.head_cut(None, 4, 2)


def test_one_rank_engine_is_the_one_device_engine():
    """A group of one rank takes today's path: no ``tp`` in the params and
    the same tokens as ``tp=None``."""
    cfg = t_get_config("llama2-7b").reduced(vocab_size=128)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = np.arange(1, 13, dtype=np.int32).reshape(2, 6) % 120 + 1
    a = ServeEngine(cfg, params, max_len=32, device="cpu")
    b = ServeEngine(cfg, params, max_len=32, device="cpu",
                    tp=_Group(1))
    assert b.tp is None and "tp" not in b.params
    assert np.array_equal(a.generate(prompts, max_new=4)["tokens"],
                          b.generate(prompts, max_new=4)["tokens"])
