"""The port's dry run (``repro_torch/launch/{dryrun,op_analysis,reanalyze,
report}.py``, ``kernels/costs.py``, ``api.input_specs``) against the JAX
package's (``repro/launch/{dryrun,hlo_analysis,report}.py``).

The functions that depend only on the config, ``input_specs``,
``Roofline`` (given the TPU v5e peaks) and ``fmt_row`` are held equal to
the JAX package's; the tally is held to programs counted by hand; the
traced FLOPs of a reduced prefill and train step are held to
``hlo_analysis.analyze`` of the reference's compiled step with attention
set apart: both with the attention replaced by a dot-free stand-in (the
rest, projections, head and their gradients, must agree within 1e-6),
and the attention each counts by its own rule (the port by visible pairs,
the reference at half weight over its padded blocks, the causal
``lax.cond``).

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
for the process, so its functions run in a subprocess.
"""
import dataclasses
import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import ShapeConfig as JShape
from repro.kernels import ops as jops
from repro.launch import hlo_analysis as H
from repro.launch import report as jreport
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import costs, ops
from repro_torch.launch import dryrun, op_analysis as oa, reanalyze, report
from repro_torch.models import api
from torch_cases import bf16_ulp_of

ROOT = Path(__file__).resolve().parent.parent
META = torch.device("meta")

# the JAX package's config-only functions, every ASSIGNED x SHAPES x
# variant, as JSON (a subprocess: the import sets XLA_FLAGS)
_JAX_SCRIPT = r"""
import dataclasses, json
from repro.configs import SHAPES, get_config, registry
from repro.launch import dryrun

class Mesh:
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")

out = {"assigned": registry.ASSIGNED, "cells": {}}
for arch in registry.ASSIGNED:
    for name, shape in SHAPES.items():
        for variant in ("baseline", "opt"):
            base = get_config(arch)
            cfg = dryrun.apply_variant(base, shape, variant)
            ad = dryrun.adapt_parallel(cfg, shape, Mesh())
            out["cells"][f"{arch}|{name}|{variant}"] = {
                "skip": dryrun.cell_skip_reason(base, shape),
                "variant": dataclasses.asdict(cfg),
                "adapted": dataclasses.asdict(ad),
                "model_flops": dryrun.model_flops(ad, shape),
                "model_bytes": dryrun.model_bytes(ad, shape)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _plain(d):
    """asdict of a config with tuples as lists (JSON's view)."""
    return json.loads(json.dumps(d))


def test_config_only_functions_equal_the_jax_package(jax_cells):
    assert ASSIGNED == jax_cells["assigned"]
    n = 0
    for arch in ASSIGNED:
        for name, shape in SHAPES.items():
            for variant in ("baseline", "opt"):
                want = jax_cells["cells"][f"{arch}|{name}|{variant}"]
                base = get_config(arch)
                cfg = dryrun.apply_variant(base, shape, variant)
                ad = dryrun.adapt_parallel(cfg, shape, dryrun.grid_shape())
                assert dryrun.cell_skip_reason(base, shape) == want["skip"]
                assert _plain(dataclasses.asdict(cfg)) == want["variant"]
                assert _plain(dataclasses.asdict(ad)) == want["adapted"]
                assert dryrun.model_flops(ad, shape) == want["model_flops"]
                assert dryrun.model_bytes(ad, shape) == want["model_bytes"]
                n += 1
    assert n == 80
    skipped = [k for k, v in jax_cells["cells"].items()
               if v["skip"] and k.endswith("|baseline")]
    assert len(skipped) == 8 and all("|long_500k|" in k for k in skipped)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_equal_the_jax_package(arch):
    for shape in SHAPES.values():
        want = japi.input_specs(jget(arch), JShape(shape.name, shape.seq_len,
                                                   shape.global_batch,
                                                   shape.kind))
        got = api.input_specs(get_config(arch), shape)
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert got[k].is_meta
            assert tuple(got[k].shape) == tuple(s.shape)
            assert str(got[k].dtype).split(".")[-1] == str(s.dtype)


def test_roofline_equals_hlo_analysis_at_tpu_peaks():
    cases = [dict(hlo_flops=3.1e18, hlo_bytes=2.2e15, coll_bytes_per_chip=7e9,
                  chips=256, model_flops=1.7e18, model_bytes=9e14),
             dict(hlo_flops=5e12, hlo_bytes=8e13, coll_bytes_per_chip=1e6,
                  chips=256, model_flops=2e12, model_bytes=6e11),
             dict(hlo_flops=1e10, hlo_bytes=1e9, coll_bytes_per_chip=5e11,
                  chips=1, model_flops=0.0)]
    for kw in cases:
        want = H.Roofline(**kw).as_dict()
        got = oa.Roofline(**kw, peak_flops=H.PEAK_FLOPS, hbm_bw=H.HBM_BW,
                          link_bw=H.ICI_BW).as_dict()
        assert got == want
    h100 = oa.Roofline(**cases[0])
    assert (h100.peak_flops, h100.hbm_bw, h100.link_bw) == (989e12, 3.35e12,
                                                            50e9)


def test_fmt_row_equals_the_jax_package():
    roof = oa.Roofline(hlo_flops=4e15, hlo_bytes=3e14, coll_bytes_per_chip=2e8,
                       chips=256, model_flops=3e15, model_bytes=1e13).as_dict()
    rows = [{"arch": "granite-8b", "shape": "train_4k", "mesh": "16x16",
             "status": "ok", "roofline": roof},
            {"arch": "gemma2-27b", "shape": "long_500k", "mesh": "16x16",
             "status": "skipped",
             "reason": dryrun.cell_skip_reason(get_config("gemma2-27b"),
                                               SHAPES["long_500k"])},
            {"arch": "rwkv6-7b", "shape": "decode_32k", "mesh": "16x16",
             "status": "error"}]
    for r in rows:
        assert report.fmt_row(r) == jreport.fmt_row(r)


# ----------------------------------------------------------------- the tally
def _traced(fn, *held):
    tally = oa.Tally()
    tally.hold(*held)
    with tally:
        out = fn()
    return tally, out


def test_loop_of_matmuls_counts_each_iteration():
    L, M, K, N = 5, 8, 32, 16
    x = torch.empty((M, K), device=META)
    w = torch.empty((K, N), device=META)

    def run():
        return [x @ w for _ in range(L)]

    t, _ = _traced(run, x, w)
    assert t.flops == L * 2 * M * K * N
    assert t.mem_bytes == L * 4 * (M * K + K * N + M * N)
    assert t.mem_by_kind == {"mm": t.mem_bytes}


def test_repeat_weights_one_traced_iteration():
    x = torch.empty((8, 32), device=META)
    w = torch.empty((32, 32), device=META)

    def run():
        with costs.repeat(7):
            return x @ w

    t, _ = _traced(run, x, w)
    assert t.flops == 7 * 2 * 8 * 32 * 32


def test_one_layers_slice_of_a_stacked_weight_counts_one_layer():
    L, M, D = 6, 4, 64
    stack = torch.empty((L, D, D), device=META)
    x = torch.empty((M, D), device=META)

    def run():
        return x @ stack[2]

    t, _ = _traced(run, stack, x)
    assert t.flops == 2 * M * D * D
    assert t.mem_bytes == 4 * (M * D + D * D + M * D)


def test_in_place_slice_write_counts_the_update_twice():
    cache = torch.empty((4, 1024, 64), device=META)
    upd = torch.empty((4, 1, 64), device=META)

    def run():
        cache[:, 7:8].copy_(upd)
        return cache

    t, _ = _traced(run, cache, upd)
    assert t.mem_bytes == 2 * upd.numel() * 4
    assert t.peak == 0                      # nothing allocated


def test_gather_counts_its_result_twice():
    table = torch.empty((1000, 64), device=META)
    ids = torch.empty((8,), dtype=torch.int64, device=META)

    def run():
        return torch.embedding(table, ids)

    t, out = _traced(run, table, ids)
    assert t.mem_bytes == 2 * out.numel() * 4


def test_stand_in_group_records_collective_bytes_at_tp4():
    g = oa.StandInGroup(4)
    x = torch.empty((8, 256), dtype=torch.bfloat16, device=META)
    n = x.numel() * 2

    def run():
        parts = g.all_gather(x)
        assert len(parts) == 4 and all(p.shape == x.shape for p in parts)
        g.all_reduce(x)
        out = g.reduce_scatter(x, dim=1)
        assert tuple(out.shape) == (8, 64)
        g.broadcast(x)
        return out

    t, _ = _traced(run, x)
    assert t.coll["all-gather"] == 4 * n
    assert t.coll["all-reduce"] == 2 * n
    assert t.coll["reduce-scatter"] == 3 * (n // 4)
    assert t.coll["broadcast"] == n
    assert t.coll_counts == {"all-reduce": 1, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 0, "broadcast": 1}
    one = oa.StandInGroup(1)
    t, _ = _traced(lambda: (one.all_gather(x), one.all_reduce(x)), x)
    assert sum(t.coll.values()) == 0


def test_live_storage_peak():
    a_bytes, b_bytes, c_bytes = 4 * 1000, 4 * 3000, 4 * 500
    x = torch.empty((1000,), device=META)

    def run():
        a = x * 2                      # 4,000 live
        b = torch.empty((3000,), device=META).fill_(1.0)   # 16,000 live
        del a
        c = b[:500] + 1                # 14,000
        return c

    t, _ = _traced(run, x)
    assert t.peak == a_bytes + b_bytes
    assert t.live == c_bytes           # b died with the frame
    reads = oa.Tally()
    with reads:
        assert int(x.sum()) == 0 and not bool((x > 0).any())
    assert sum(reads.host_reads.values()) == 2


def test_each_kernels_meta_record_is_its_formula():
    bf16 = torch.bfloat16
    qx = torch.empty((8, 512), dtype=torch.int8, device=META)
    codes = torch.empty((512, 256), dtype=torch.int8, device=META)
    q = torch.empty((2, 8, 96, 64), dtype=bf16, device=META)
    k = torch.empty((2, 2, 96, 64), dtype=bf16, device=META)
    qd = torch.empty((4, 8, 1, 64), dtype=bf16, device=META)
    pool = torch.empty((40, 16, 2, 64), dtype=bf16, device=META)
    table = torch.empty((4, 10), dtype=torch.int32, device=META)
    lens = torch.empty((4,), dtype=torch.int32, device=META)
    r = torch.empty((1, 4, 33, 64), dtype=bf16, device=META)
    u = torch.empty((4, 64), device=META)
    calls = [
        ("w4a8_matmul", lambda: ops.w4a8_matmul(
            qx, torch.empty((8, 1), device=META), codes,
            torch.empty((256,), device=META)), costs.w4a8(8, 512, 256),
         (8, 256)),
        ("flash_attention", lambda: ops.attention(q, k, k, window=40),
         costs.flash(2, 8, 2, 96, 96, 64, 2, True, 40), tuple(q.shape)),
        ("paged_decode_attention", lambda: ops.paged_decode_attention(
            qd, pool, pool, table, lens),
         costs.paged(4, 8, 2, 64, 4 * 10 * 16, 10, 40), tuple(qd.shape)),
        ("rwkv6_scan", lambda: ops.rwkv6(r, r, r, r, u)[0],
         costs.rwkv(1, 4, 33, 64, 2), tuple(r.shape))]
    for name, fn, (nbytes, flops), shape in calls:
        t, out = _traced(fn)
        assert t.kernel_calls == {name: 1}
        assert t.flops == flops and t.kernel_flops == flops
        assert t.mem_by_kind[name] == nbytes
        assert tuple(out.shape) == shape and out.is_meta
    assert costs.attention_pairs(96, 96, True, 40) == sum(
        min(i + 1, 40) for i in range(96))
    assert costs.attention_pairs(5, 9, True, None, 4) == sum(
        min(i + 5, 9) for i in range(5))


# ------------------------------------------------------------- whole cells
@pytest.fixture(scope="module")
def granite_decode(tmp_path_factory):
    """granite-8b decode_32k at full width on the (16, 16) grid, with its
    record saved for reanalyze."""
    rec_dir = tmp_path_factory.mktemp("records")
    os.environ["REPRO_TORCH_RECORD_DIR"] = str(rec_dir)
    try:
        res = dryrun.lower_cell("granite-8b", "decode_32k")
    finally:
        del os.environ["REPRO_TORCH_RECORD_DIR"]
    return res, rec_dir


def test_full_width_decode_cell_at_16x16(granite_decode):
    res, _ = granite_decode
    cfg = get_config("granite-8b")
    assert res["status"] == "ok" and res["layout"] == "serve"
    assert res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["trace_s"] < 20
    # the rank: 128 / 16 rows, weights cut over "model" only (bf16
    # projections, float32 embedding, norms and head), and the whole
    # K/V: 8 KV heads do not divide over 16 ranks
    rows, L, hd = 8, cfg.num_layers, cfg.resolved_head_dim
    cache = 2 * L * rows * cfg.num_kv_heads * 32768 * hd * 2 + rows * 4
    assert res["memory"]["argument_size_in_bytes"] > cache
    assert res["kernel_calls"] == {}
    roof = res["roofline"]
    assert roof["model_flops"] == dryrun.model_flops(cfg, SHAPES["decode_32k"])
    assert roof["bottleneck"] == "memory"
    assert set(res["collectives"]["by_kind"]) >= {"all-gather", "all-reduce"}


def test_reanalyze_rebuilds_the_traced_json(granite_decode, tmp_path):
    res, rec_dir = granite_decode
    out = tmp_path / "out"
    reanalyze.main(["--record-dir", str(rec_dir), "--out", str(out)])
    got = json.loads((out / "granite-8b__decode_32k__pod1.json").read_text())
    assert got == json.loads(json.dumps(res))
    with gzip.open(rec_dir / "granite-8b__decode_32k__pod1.json.gz", "rt") as f:
        assert json.load(f)["chips"] == 256


def test_alike_steps_traced_once_count_as_each(monkeypatch):
    """A LAQ MoE layer's expert stack and the sequence-cut decode's combine
    over ranks are traced once and weighted (``costs.repeat``): a reduced
    qwen3-moe opt decode at (1, 4) counts the same kernels, totals and
    memory as the same trace that walks every expert and every rank."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import build
    from repro_torch.models import moe
    shape = ShapeConfig("d", 64, 4, "decode")
    cfg = dryrun.apply_variant(get_config("qwen3-moe-235b-a22b").reduced(),
                               shape, "opt")
    cfg = dryrun.adapt_parallel(cfg, shape, dryrun.grid_shape((1, 4)))
    assert cfg.parallel.decode_attn == "shard_map" and cfg.moe.num_experts > 1
    weighted = dryrun.trace(cfg, shape, (1, 4))

    class EveryStep:                  # the meta branches not taken
        def __getattr__(self, name):
            return getattr(build, name)

        @staticmethod
        def is_meta(t):
            return False
    monkeypatch.setattr(moe, "build", EveryStep())
    monkeypatch.setattr(collectives, "build", EveryStep())
    each = dryrun.trace(cfg, shape, (1, 4))
    for key in ("kernel_calls", "totals", "memory"):
        assert weighted[key] == each[key], key
    assert weighted["totals"]["coll_counts"]["all-gather"] > 0


def test_skipped_and_refused_cells(capsys):
    res = dryrun.lower_cell("gemma2-27b", "long_500k")
    assert res["status"] == "skipped" and "500k" in res["reason"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "gemma2-27b", "--shape", "train_4k",
                     "--multi-pod"])
    assert "runtime.Grid" in capsys.readouterr().err


# ------------------------------------------- FLOPs against the reference
def _dot_free_attention(q, k, v, **_):
    return q * 1.0 + 0.0 * (k.mean() + v.mean()).astype(q.dtype)


def _ref_flops(cfg, shape, no_attention):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    saved = jops.attention
    if no_attention:
        jops.attention = _dot_free_attention
    try:
        params = jax.eval_shape(lambda k: japi.init_params(cfg, k),
                                jax.random.PRNGKey(0))
        specs = japi.input_specs(cfg, shape)
        with mesh:
            if shape.kind == "prefill":
                c = jstep.make_prefill_step(cfg, mesh)(params).lower(
                    params, specs).compile()
            else:
                oc = jopt.AdamWConfig()
                opt = jax.eval_shape(lambda p: jopt.init_state(p, oc), params)
                batch = dict(specs, mask=jax.ShapeDtypeStruct(
                    (shape.global_batch, shape.seq_len), jnp.float32))
                c = jstep.make_train_step(cfg, oc, mesh, params, opt).lower(
                    params, opt, batch).compile()
    finally:
        jops.attention = saved
    return H.analyze(c.as_text()).flops_per_chip


def _port_flops(cfg, shape, no_attention, monkeypatch):
    with monkeypatch.context() as m:
        if no_attention:
            m.setattr(ops, "attention", lambda q, k, v, **_: q * 1.0 + 0.0 * (
                k.mean() + v.mean()).to(q.dtype))
        rec = dryrun.trace(cfg, shape, (1, 1))
    return rec["totals"]["flops_per_chip"], rec["kernel_flops"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_traced_flops_against_the_reference_analyzer(kind, monkeypatch):
    B, T = 2, 64
    jcfg, cfg = jget("stablelm-1.6b").reduced(), get_config(
        "stablelm-1.6b").reduced()
    shape = ShapeConfig("s", T, B, kind)
    jshape = JShape("s", T, B, kind)
    ref_all = _ref_flops(jcfg, jshape, False)
    ref_rest = _ref_flops(jcfg, jshape, True)
    got_all, kernel = _port_flops(cfg, shape, False, monkeypatch)
    got_rest, _ = _port_flops(cfg, shape, True, monkeypatch)
    # everything but attention: the same products on both sides
    assert got_rest == pytest.approx(ref_rest, rel=1e-6)
    L, D, Hq = cfg.num_layers, cfg.resolved_head_dim, cfg.num_heads
    launch = costs.flash(B, Hq, cfg.num_kv_heads, T, T, D, 2)[1]
    # the reference: its chunked attention pads to one 512 x 1024 block
    # whose two dots count at half weight (the causal lax.cond)
    ref_block = 0.5 * 2 * (2 * B * Hq * 512 * 1024 * D)
    if kind == "prefill":
        assert kernel == L * launch
        assert got_all - got_rest == L * launch
        assert ref_all - ref_rest == pytest.approx(L * ref_block, rel=1e-6)
    else:
        # remat "full" runs the forward twice; the backward is the plain
        # attention's recomputed forward (two T x T dots) and its four
        # gradient dots
        assert kernel == 2 * L * launch
        plain = 2 * (2 * B * Hq * T * T * D)
        assert got_all - got_rest == 2 * L * launch + L * 3 * plain
        assert ref_all - ref_rest == pytest.approx(4 * L * ref_block,
                                                   rel=1e-6)


# ------------------------------------- LAQ-quantized decode (opt decode)
def test_laq_head_product_equals_the_jax_linear():
    """A LAQ-quantized LM head (``--variant opt`` decode): the port's
    ``layers.head_logits`` equals the JAX package's compiled ``linear(x,
    head).astype(float32)`` bit for bit on the same codes (the activation
    scale ``amax`` times the reciprocal of 127, as XLA compiles the
    division)."""
    from repro.core import quant as jquant
    from repro.models import layers as jL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 256)).astype(np.float32) * 0.05
    x = rng.standard_normal((64, 64)).astype(np.float32)
    jql = jquant.quantize_weights(jnp.asarray(w))
    want = np.asarray(jax.jit(lambda x, w: jL.linear(x, w).astype(
        jnp.float32))(jnp.asarray(x, jnp.bfloat16), jql))
    ql = api.params_from_numpy({"w": jax.tree.map(np.asarray, jql)},
                               "cpu")["w"]
    xb = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)
    got = L.head_logits(xb, ql, torch.bfloat16)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-7b", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_quantized_decode_step_runs_in_every_family(arch):
    """Every family's decode step on LAQ-quantized params, the LM head
    included (the JAX package's H3 serving weights): the JAX package's
    ``init_params`` weights quantized on both sides (``quantize_model``),
    then three decode steps of seeded tokens (seamless from the cache's
    cross K/V of a seeded frontend), each step's logits within one bf16
    ulp of the largest |logit| of the JAX package's jitted decode step,
    with the same greedy tokens.  seamless's encoder runs the JAX
    package's Pallas flash kernel in interpret mode, which the port's
    plain attention follows."""
    B, S, steps = 2, 8, 3
    jcfg = dataclasses.replace(jget(arch).reduced(),
                               use_pallas=arch == "seamless-m4t-medium")
    cfg = get_config(arch).reduced()
    jp = jax.jit(japi.init_params, static_argnums=0)(jcfg,
                                                     jax.random.PRNGKey(0))
    jq = japi.quantize_model(jp, jcfg)
    params = api.quantize_model(
        api.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), cfg)
    assert type(params["lm_head"]).__name__ == "QuantizedLinear"
    rng = np.random.default_rng(1)
    fe = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
          .astype(np.float32) if cfg.frontend_tokens else None)
    jc = japi.init_cache(jcfg, B, S, params=jq,
                         frontend=None if fe is None else jnp.asarray(fe))
    cache = api.init_cache(cfg, B, S, params=params, device="cpu",
                           frontend=None if fe is None
                           else torch.from_numpy(fe))
    step = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jcfg))
    toks = rng.integers(1, 256, (B, steps)).astype(np.int32)
    for t in range(steps):
        jl, jc = step(jq, jc, jnp.asarray(toks[:, t]))
        logits, cache = api.decode_step(params, cache,
                                        torch.from_numpy(toks[:, t]), cfg)
        jl = np.asarray(jl)
        assert tuple(logits.shape) == (B, cfg.vocab_size)
        assert np.abs(logits.numpy() - jl).max() <= bf16_ulp_of(
            np.abs(jl).max())
        np.testing.assert_array_equal(logits.numpy().argmax(-1),
                                      jl.argmax(-1))
