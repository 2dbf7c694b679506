"""The port's MoE FFN (``models/moe.py``) and the lm family's MoE blocks
against the JAX package, on the same weights.

Three reduced configs: phi3.5-moe-42b-a6.6b and qwen3-moe-235b-a22b (both
reduce to 4 experts, top-2, 4/2 heads of 16; their weights come from two
seeds) and the top-8 override ``reduced(num_heads=16, num_kv_heads=1,
moe=MoEConfig(16, 8))``: qwen's routing shape and a GQA group of 16.
The reference's ``moe_apply`` and model steps run jitted on the CPU.

Tolerances, each beside its check:
* ``moe_apply``'s ``out``: bit-identical, on rows where the reference drops
  assignments by capacity (recomputed here from the reference's own
  router), on tied router probabilities and on the quantized (W4A8) branch;
* ``aux`` (which serving discards): bit-identical at 4 experts from two
  rows up.  At 16 experts the order in which XLA's vectorised fused
  reduction adds the 16 products changes with the row count, and on one
  row at 4 experts XLA's router product sums in an order the port does
  not reproduce (an ulp on some router logits, which the gates' bf16
  rounding hides from ``out``): held to 4 float32 ulps there;
* the model's block prefill and its dense and paged decode steps: logits
  within two bf16 ulps of the largest |logit| (1.11 measured) and the same
  greedy tokens; reduced phi3.5-moe's are bit-identical at every step of
  this test, the other two differ on some.  Given the same norm output
  the MoE is bit-identical; what differs is upstream of it: the port's
  rmsnorm sums and takes rsqrt otherwise than XLA, one bf16 ulp on a few
  rows in a hundred (``tests/test_torch_rmsnorm_xla.py``), and at the
  top-8 override's GQA group of 16 the plain flash version rounds 2 of
  12,288 prefill outputs otherwise than the Pallas kernel in interpret
  mode.  Behind a router such an ulp moves a gate and so the block's
  output by more than a dense block would, and the cache carries it.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config
from repro.configs.base import MoEConfig as JMoE
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import CONFIGS
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import api, moe
from repro_torch.models.api import params_from_numpy
from torch_cases import bf16_ulp_of

CASES = {"phi": ("phi3.5-moe-42b-a6.6b", 0, {}),
         "qwen": ("qwen3-moe-235b-a22b", 1, {}),
         "top8": ("qwen3-moe-235b-a22b", 2,
                  dict(num_heads=16, num_kv_heads=1))}
_SETUPS = {}


def configs(case):
    arch, _, kw = CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if case == "top8":
        jkw["moe"], tkw["moe"] = JMoE(16, 8), MoEConfig(16, 8)
    cfg = dataclasses.replace(get_config(arch).reduced(**jkw),
                              use_pallas=True)
    return cfg, t_get_config(arch).reduced(**tkw)


def setup_for(case):
    if case not in _SETUPS:
        cfg, tcfg = configs(case)
        params = jax.jit(japi.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(CASES[case][1]))
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        _SETUPS[case] = dict(
            cfg=cfg, tcfg=tcfg, params=params, mesh=mesh,
            tparams=params_from_numpy(jax.tree.map(np.asarray, params),
                                      "cpu"))
    return _SETUPS[case]


def _layer0(tree):
    return jax.tree.map(lambda a: a[0, 0], tree)


def _x(n, seed, d=64, shared=0.0):
    """(1, n, d) bf16 rows, standard normal; ``shared`` mixes one common
    row into all (similar rows route alike, so capacity binds)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, n, d)) + shared * rng.standard_normal(d)
    return jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)


def _t(a):
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32)))


def _reference_keep(p, x, mcfg):
    """The reference's capacity decision, recomputed from its own jitted
    router (``lax.top_k`` on its softmax) with numpy: per-row bool (n, k),
    True where an assignment is kept."""
    def router(p, x):
        xt = x.reshape(-1, x.shape[-1])
        lg = (xt @ p["router"].astype(xt.dtype)).astype(jnp.float32)
        return jax.lax.top_k(jax.nn.softmax(lg, -1), mcfg.top_k)[1]
    ids = np.asarray(jax.jit(router)(p, x))
    n, k = ids.shape
    C = max(1, math.ceil(n * k / mcfg.num_experts * mcfg.capacity_factor))
    seen = np.zeros(mcfg.num_experts, np.int64)
    keep = np.zeros((n, k), bool)
    for e in range(mcfg.num_experts):     # stable: earlier rows first
        for r in range(n):
            for j in range(k):
                if ids[r, j] == e:
                    keep[r, j] = seen[e] < C
                    seen[e] += 1
    return ids, keep


def _assert_moe_apply(p, tp, x, cfg, tcfg):
    jout, jaux = jax.jit(jmoe.moe_apply, static_argnums=2)(p, x, cfg.moe)
    tout, taux = moe.moe_apply(tp, _t(x).to(torch.bfloat16), tcfg.moe)
    assert tout.dtype == torch.bfloat16 and taux.dtype == torch.float32
    np.testing.assert_array_equal(tout.float().numpy(), _t(jout).numpy())
    if cfg.moe.num_experts <= 4 and x.shape[1] > 1:
        assert float(taux) == float(jaux)
    else:
        assert abs(float(taux) - float(jaux)) <= 4 * np.spacing(
            np.float32(jaux))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n,drops", [(1, False), (2, False), (8, True),
                                     (32, True), (64, True)],
                         ids=["n1", "n2", "decode8", "prefill32",
                              "prefill64"])
def test_moe_apply_bit_identical_with_and_without_drops(case, n, drops):
    """Layer 0's MoE on ``n`` rows: with 2 rows the capacity is n (no
    drop can happen); with 8 rows (a decode batch of 8 slots) and with a
    32- or 64-token prefill of similar rows the reference drops
    assignments -- checked here from its own router."""
    s = setup_for(case)
    p, tp = _layer0(s["params"]["blocks"]["moe"]), _layer0(
        s["tparams"]["blocks"]["moe"])
    x = _x(n, n, shared=2.0 if drops else 0.0)
    ids, keep = _reference_keep(p, x, s["cfg"].moe)
    assert (~keep).any() == drops
    C = moe.capacity(n, s["tcfg"].moe)
    _, _, tids = moe.route(tp, _t(x)[0].to(torch.bfloat16), s["tcfg"].moe)
    np.testing.assert_array_equal(tids.numpy(), ids)
    _, _, tkeep, _ = moe.dispatch(tids, C, s["tcfg"].moe.num_experts)
    order = np.argsort(ids.reshape(-1), kind="stable")
    np.testing.assert_array_equal(tkeep.numpy(), keep.reshape(-1)[order])
    _assert_moe_apply(p, tp, x, s["cfg"], s["tcfg"])


@pytest.mark.parametrize("case", ["phi", "top8"])
def test_tied_router_probabilities_break_to_the_lower_index(case):
    """Router columns 0 and 1 identical: every row ties experts 0 and 1,
    and ``lax.top_k`` takes the lower index first; the port's ids, and
    its output, are the reference's."""
    s = setup_for(case)
    p = _layer0(s["params"]["blocks"]["moe"])
    p = dict(p, router=p["router"].at[:, 1].set(p["router"][:, 0]))
    tp = params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    x = _x(16, 5)
    ids, _ = _reference_keep(p, x, s["cfg"].moe)
    probs, _, tids = moe.route(tp, _t(x)[0].to(torch.bfloat16),
                               s["tcfg"].moe)
    assert torch.equal(probs[:, 0], probs[:, 1])
    assert ((ids == 0).any(1) & (ids == 1).any(1)).any()   # both in top-k
    # where only one of the tied pair is in the top-k, it is expert 0
    assert not ((ids == 1).any(1) & ~(ids == 0).any(1)).any()
    np.testing.assert_array_equal(tids.numpy(), ids)
    _assert_moe_apply(p, tp, x, s["cfg"], s["tcfg"])


@pytest.mark.parametrize("case", ["phi", "top8"])
@pytest.mark.parametrize("n", [1, 8, 32])
def test_quantized_experts_bit_identical(case, n):
    """The W4A8 branch: the model quantized by each package's
    ``quantize_model`` (expert stacks (G, gs, E, d, f) quantized one (d, f)
    matrix at a time, the router kept float) gives identical codes and
    scales, and layer 0's ``moe_apply`` on them gives the jitted
    reference's bits."""
    s = setup_for(case)
    jq = japi.quantize_model(s["params"], s["cfg"])
    tq = api.quantize_model(s["tparams"], s["tcfg"])
    for name in ("w1", "w2", "w3"):
        jw, tw = jq["blocks"]["moe"][name], tq["blocks"]["moe"][name]
        np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes))
        np.testing.assert_array_equal(tw.scales.numpy(),
                                      np.asarray(jw.scales))
    assert torch.is_tensor(tq["blocks"]["moe"]["router"])
    p = _layer0(jq["blocks"]["moe"])
    tp = {k: v[0, 0] for k, v in tq["blocks"]["moe"].items()}
    _assert_moe_apply(p, tp, _x(n, 7), s["cfg"], s["tcfg"])


def _hold_logits(tl, jl):
    """One step's logits: within two bf16 ulps of the largest |logit|, the
    same greedy tokens (module docstring)."""
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 2 * bf16_ulp_of(
        np.abs(jl).max())
    np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))


@pytest.mark.parametrize("case", list(CASES))
def test_block_prefill_and_decode_logits_match_reference(case):
    """The MoE model's serve path on the engine's copy of the weights
    (``serve_params``): a 2-row block prefill of a 24-token body (48 rows
    in each layer's MoE), then 6 dense decode steps, and 12 steps through
    the page pool (a shuffled table, row 1 frozen on every third step),
    against the reference's jitted ``prefill`` / ``decode_step`` /
    ``paged_decode_step`` with its Pallas kernels in interpret mode."""
    s = setup_for(case)
    cfg, tcfg = s["cfg"], s["tcfg"]
    tparams = api.family_module(tcfg).serve_params(s["tparams"], tcfg,
                                                   torch.device("cpu"))
    toks = np.random.default_rng(4).integers(1, 256, (2, 30)).astype(
        np.int32)
    with s["mesh"]:
        jc = japi.init_cache(cfg, 2, 32)
        jl, jc = jax.jit(lambda p, c, t: japi.prefill(p, c, t, cfg))(
            s["params"], jc, jnp.asarray(toks[:, :24]))
    tc = api.init_cache(tcfg, 2, 32, device="cpu")
    tl, tc = api.prefill(tparams, tc, torch.from_numpy(toks[:, :24]), tcfg)
    _hold_logits(tl, jl)
    step = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cfg))
    for t in range(24, 30):
        jl, jc = step(s["params"], jc, jnp.asarray(toks[:, t]))
        tl, tc = api.decode_step(tparams, tc, torch.from_numpy(toks[:, t]),
                                 tcfg)
        _hold_logits(tl, jl)
    # the page pool: 2 slots of 2 pages of 8, the table shuffled
    B, NP, ps = 2, 6, 8
    table = np.array([[3, 5], [1, 4]], np.int32)
    leaf = (tcfg.num_layers, 1, NP, ps, tcfg.num_kv_heads,
            tcfg.resolved_head_dim)
    jpc = {"k": [jnp.zeros(leaf, jnp.bfloat16)],
           "v": [jnp.zeros(leaf, jnp.bfloat16)],
           "len": jnp.zeros((B,), jnp.int32)}
    tpc = {"k": [torch.zeros(leaf, dtype=torch.bfloat16)],
           "v": [torch.zeros(leaf, dtype=torch.bfloat16)],
           "len": torch.zeros((B,), dtype=torch.int32)}
    ragged = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, aligned_decode=False))
    pstep = jax.jit(lambda p, c, tb, t, w: jtr.paged_decode_step(
        p, c, tb, t, ragged, write=w, seq_axes={"k": [4], "v": [4]}))
    for t in range(12):
        write = np.array([True, t % 3 != 2])
        jl, jpc = pstep(s["params"], jpc, jnp.asarray(table),
                        jnp.asarray(toks[:, t]), jnp.asarray(write))
        tl, tpc = api.paged_decode_step(
            tparams, tpc, torch.from_numpy(table),
            torch.from_numpy(toks[:, t]), tcfg,
            write=torch.from_numpy(write))
        _hold_logits(tl[write], np.asarray(jl)[write])
    np.testing.assert_array_equal(tpc["len"].numpy(), np.asarray(jpc["len"]))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"])
def test_config_equals_the_jax_package_and_is_served(arch):
    for full in (True, False):
        a, b = get_config(arch), t_get_config(arch)
        if not full:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert b.param_count() == a.param_count()
    assert arch in CONFIGS and CONFIGS[arch].family in tserve.SERVED


def test_init_params_draws_the_moe_stacks_into_the_projection_dtype():
    """The port's own draws: every block holds ``moe`` (no ``mlp``), the
    router and expert stacks in the projection dtype with the reference's
    bounds (+-1/sqrt(d) for router, w1, w3; +-1/sqrt(f) for w2), and
    serve_params keeps a bf16 tree without copying it."""
    tcfg = t_get_config("qwen3-moe-235b-a22b").reduced(
        moe=MoEConfig(16, 8))
    gen = torch.Generator().manual_seed(0)
    p = api.init_params(tcfg, gen, "cpu", dtype=torch.bfloat16)
    m = p["blocks"]["moe"]
    assert "mlp" not in p["blocks"]
    d, f, E = tcfg.d_model, tcfg.d_ff, 16
    want = {"router": ((d, E), d), "w1": ((E, d, f), d),
            "w3": ((E, d, f), d), "w2": ((E, f, d), f)}
    for name, (shape, fan) in want.items():
        w = m[name]
        assert tuple(w.shape) == (tcfg.num_layers, 1) + shape
        assert w.dtype == torch.bfloat16
        assert float(w.float().abs().max()) <= 1.0 / math.sqrt(fan) * 1.004
        assert float(w.float().std()) > 0.4 / math.sqrt(fan)
    sp = api.family_module(tcfg).serve_params(p, tcfg, torch.device("cpu"))
    for name in want:
        assert sp["blocks"]["moe"][name].data_ptr() == m[name].data_ptr()


def test_split_brain_engines_refuse_moe():
    """The split-brain protocol covers dense FFNs: both packages' engines
    refuse a MoE config with the same error."""
    from repro.serve.splitbrain_engine import SplitBrainEngine as JSplit
    from repro_torch.serve.splitbrain_engine import SplitBrainEngine
    s = setup_for("phi")
    for make in (lambda: JSplit(s["cfg"], s["params"], mesh=s["mesh"]),
                 lambda: SplitBrainEngine(s["tcfg"], s["tparams"],
                                          device="cpu")):
        with pytest.raises(ValueError, match="dense FFNs"):
            make()
