"""The port's RWKV6 scans and reduced rwkv6-7b model functions against the
JAX package's, on the same inputs and weights.

The plain ``rwkv6_scan`` (the CPU path and the CUDA kernel's yardstick)
against the JAX oracle ``ref.rwkv6_scan`` and the Pallas kernel in
interpret mode, at the JAX kernel tests' shapes, in float32 and bfloat16,
and against the oracle alone with a carried state and at a ragged T (the
Pallas kernel takes neither).  Tolerances: float32 outputs and every final
state within atol 1e-4 (the JAX kernel test's); bfloat16 outputs within one
bfloat16 ulp of the reference's, since the float32 sum over the k-dim runs
in another order and can move the final rounding.

Model functions: ``forward`` (the JAX one dispatches its Pallas kernel,
``use_pallas=True``), ``decode_step`` and ``api.prefill`` (a scan of
``decode_step``) against the jitted JAX functions.  The port rounds where
those compiled programs round, so the logits are bit-identical.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp

from repro.configs import get_config
from repro.kernels import ref as jref
from repro.kernels.rwkv_scan import rwkv6_scan as pallas_rwkv6_scan
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import api
from repro_torch.models.api import params_from_numpy
from torch_cases import assert_within_bf16_ulp, rwkv_case

SHAPES = [(2, 3, 64, 16, 16), (1, 2, 128, 32, 64), (1, 1, 32, 64, 32)]


def _check(ours, want, dtype):
    out, state = ours
    w_out, w_state = (np.asarray(jnp.asarray(x, jnp.float32)) for x in want)
    assert out.dtype == dtype and state.dtype == torch.float32
    np.testing.assert_allclose(state.numpy(), w_state, rtol=0, atol=1e-4)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), w_out, rtol=0, atol=1e-4)
    else:
        assert_within_bf16_ulp(out, w_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,T,D,bt", SHAPES)
def test_plain_scan_matches_jax_ref_and_pallas(B, H, T, D, bt, dtype):
    r, k, v, w, u = rwkv_case(B, H, T, D, seed=B * T)
    ts = [torch.from_numpy(a).to(dtype) for a in (r, k, v, w)]
    ours = ref.rwkv6_scan(*ts, torch.from_numpy(u))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    js = [jnp.asarray(a).astype(jd) for a in (r, k, v, w)]
    _check(ours, jref.rwkv6_scan(*js, jnp.asarray(u)), dtype)
    _check(ours, pallas_rwkv6_scan(*js, jnp.asarray(u), bt=bt), dtype)


@pytest.mark.parametrize("T", [37, 5])
def test_plain_scan_ragged_T_and_carried_state(T):
    """A T the Pallas kernel's time blocks would refuse, from a nonzero
    carried state; and the state carried across a split equals one scan."""
    r, k, v, w, u = rwkv_case(2, 3, T, 16, seed=T)
    s0 = np.random.default_rng(1).normal(size=(2, 3, 16, 16)).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (r, k, v, w)]
    tu, ts0 = torch.from_numpy(u), torch.from_numpy(s0)
    ours = ref.rwkv6_scan(*ts, tu, state=ts0)
    _check(ours, jref.rwkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                 state=jnp.asarray(s0)), torch.float32)
    h = T // 2
    o1, s1 = ref.rwkv6_scan(*(t[:, :, :h] for t in ts), tu, state=ts0)
    o2, s2 = ref.rwkv6_scan(*(t[:, :, h:] for t in ts), tu, state=s1)
    torch.testing.assert_close(torch.cat([o1, o2], 2), ours[0], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(s2, ours[1], rtol=0, atol=1e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_plain_chunked_scan_matches_jax(chunk):
    r, k, v, w, u = rwkv_case(2, 3, 64, 16, seed=chunk)
    s0 = np.random.default_rng(2).normal(size=(2, 3, 16, 16)).astype(np.float32)
    ts = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    for state in (None, s0):
        ours = ops.rwkv6_chunked(
            *ts, None if state is None else torch.from_numpy(state),
            chunk=chunk)
        want = jref.rwkv6_scan_chunked(
            *(jnp.asarray(a) for a in (r, k, v, w, u)),
            None if state is None else jnp.asarray(state), chunk=chunk)
        _check(ours, want, torch.float32)


def test_ops_dispatch_on_the_cpu_takes_the_plain_version():
    r, k, v, w, u = (torch.from_numpy(a) for a in rwkv_case(1, 2, 9, 16))
    n0 = ops.KERNELS["rwkv6_scan"].launches
    for state in (None, torch.zeros((1, 2, 16, 16))):
        out, s = ops.rwkv6(r, k, v, w, u, state)
        want = ref.rwkv6_scan(r, k, v, w, u, state)
        assert torch.equal(out, want[0]) and torch.equal(s, want[1])
    assert ops.KERNELS["rwkv6_scan"].launches == n0


# ----------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                              use_pallas=True)
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    return dict(cfg=cfg, params=params, tcfg=t_get_config("rwkv6-7b").reduced(),
                tparams=tparams, toks=toks)


def test_params_bridge_and_init_have_the_same_tree(model):
    tcfg = model["tcfg"]
    own = api.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(tree):
        return {k: (shapes(v) if isinstance(v, dict)
                    else (tuple(v.shape), v.dtype)) for k, v in tree.items()}

    assert shapes(own) == shapes(model["tparams"])
    w0 = own["blocks"]["w0"]
    assert -8.0 <= float(w0.min()) and float(w0.max()) <= -5.0
    mix = own["blocks"]["mix"]
    assert 0.0 <= float(mix.min()) and float(mix.max()) <= 1.0


def test_forward_logits_bit_identical_to_jitted_jax(model):
    cfg, tcfg = model["cfg"], model["tcfg"]
    jl, _ = jax.jit(lambda p, t: japi.forward(p, t, cfg))(
        model["params"], jnp.asarray(model["toks"]))
    tl, aux = api.forward(model["tparams"], torch.from_numpy(model["toks"]),
                          tcfg)
    assert tl.dtype == torch.float32 and aux == 0.0
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_chunked_forward_matches_jitted_jax(model):
    """``rwkv_chunk > 0`` takes the chunked form in both packages."""
    cfg = dataclasses.replace(model["cfg"], rwkv_chunk=8)
    tcfg = dataclasses.replace(model["tcfg"], rwkv_chunk=8)
    jl, _ = jax.jit(lambda p, t: japi.forward(p, t, cfg))(
        model["params"], jnp.asarray(model["toks"]))
    tl, _ = api.forward(model["tparams"], torch.from_numpy(model["toks"]),
                        tcfg)
    jl = np.asarray(jl)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jl).max())) - 7)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=ulp)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), jl.argmax(-1))


def test_prefill_and_decode_logits_bit_identical_to_jitted_jax(model):
    cfg, tcfg, toks = model["cfg"], model["tcfg"], model["toks"]
    jc = japi.init_cache(cfg, 2, 64)
    jl, jc = jax.jit(lambda p, c, t: japi.prefill(p, c, t, cfg))(
        model["params"], jc, jnp.asarray(toks[:, :20]))
    jl2, jc = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cfg))(
        model["params"], jc, jnp.asarray(toks[:, 20]))
    tc = api.init_cache(tcfg, 2, 64, device="cpu")
    tl, tc = api.prefill(model["tparams"], tc, torch.from_numpy(toks[:, :20]),
                         tcfg)
    tl2, tc = api.decode_step(model["tparams"], tc,
                              torch.from_numpy(toks[:, 20]), tcfg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tl2.numpy(), np.asarray(jl2))
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [21, 21]
    for name in ("x_tm", "x_cm"):
        np.testing.assert_array_equal(
            tc[name].float().numpy(),
            np.asarray(jnp.asarray(jc[name], jnp.float32)))
    np.testing.assert_allclose(tc["wkv"].numpy(), np.asarray(jc["wkv"]),
                               rtol=0, atol=1e-5)


def test_masked_decode_step_freezes_inactive_rows(model):
    """``write`` False keeps a row's state, carries and ``len``; the written
    rows equal an unmasked step."""
    tcfg, p = model["tcfg"], model["tparams"]
    toks = torch.from_numpy(model["toks"][:, :5])
    a = api.init_cache(tcfg, 2, 64, device="cpu")
    _, a = api.prefill(p, a, toks, tcfg)
    b = {k: v.clone() for k, v in a.items()}
    tok = torch.tensor([7, 9], dtype=torch.int32)
    la, a = api.decode_step(p, a, tok, tcfg)
    lb, b2 = api.decode_step(p, {k: v.clone() for k, v in b.items()}, tok,
                             tcfg, write=torch.tensor([True, False]))
    assert torch.equal(la[0], lb[0])
    for name in ("wkv", "x_tm", "x_cm"):
        assert torch.equal(b2[name][:, 0], a[name][:, 0])
        assert torch.equal(b2[name][:, 1], b[name][:, 1])
    assert b2["len"].tolist() == [6, 5]


_NO_EXCESS = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import api
cfg = get_config("rwkv6-7b").reduced()
params = jax.jit(api.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
toks = jnp.asarray(np.load(sys.argv[1]))
fl, _ = jax.jit(lambda p, t: api.forward(p, t, cfg))(params, toks)
c = api.init_cache(cfg, 2, 64)
_, c = jax.jit(lambda p, c, t: api.prefill(p, c, t, cfg))(params, c, toks[:, :20])
dl, _ = jax.jit(lambda p, c, t: api.decode_step(p, c, t, cfg))(params, c, toks[:, 20])
np.savez(sys.argv[2], forward=np.asarray(fl), decode=np.asarray(dl))
"""


def test_source_order_matches_jax_without_excess_precision(model, monkeypatch,
                                                           tmp_path):
    """The two roundings the port leaves out are exactly the ones XLA drops:
    with them put back, the port's logits equal the JAX programs compiled
    with ``--xla_allow_excess_precision=false`` (the JAX source's op order)
    bit for bit."""
    import os
    import subprocess
    import sys
    from repro_torch.models import rwkv6

    def block(p, x, cfg, state=None, x_tm=None, x_cm=None):
        h, new_state, last_tm = rwkv6._time_mix(
            p, rwkv6.rmsnorm(x, p["ln_tm"], cfg.norm_eps), cfg, state=state,
            x_prev=x_tm)
        x = x + h                                  # rounded, as the source
        h, last_cm = rwkv6._channel_mix(
            p, rwkv6.rmsnorm(x, p["ln_cm"], cfg.norm_eps), x_prev=x_cm)
        return x + h, new_state, last_tm, last_cm

    head = rwkv6._head
    monkeypatch.setattr(rwkv6, "_block", block)
    monkeypatch.setattr(rwkv6, "_head", lambda params, x, cfg: head(
        params, x, cfg).to(torch.bfloat16).to(torch.float32))
    np.save(tmp_path / "toks.npy", model["toks"])
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _NO_EXCESS,
                        str(tmp_path / "toks.npy"), str(tmp_path / "out.npz")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    tcfg, p = model["tcfg"], model["tparams"]
    toks = torch.from_numpy(model["toks"])
    fl, _ = api.forward(p, toks, tcfg)
    c = api.init_cache(tcfg, 2, 64, device="cpu")
    _, c = api.prefill(p, c, toks[:, :20], tcfg)
    dl, _ = api.decode_step(p, c, toks[:, 20], tcfg)
    np.testing.assert_array_equal(fl.numpy(), want["forward"])
    np.testing.assert_array_equal(dl.numpy(), want["decode"])


def test_ulp_distance_and_the_decay_report_on_one_device():
    """``torch_cases.ulp_distance`` counts units in the last place across
    zero and in both dtypes, and the per-op decay report of a device
    against itself finds no differing element (what the card test's
    report measures is the device, not the harness)."""
    from repro_torch.models import rwkv6
    from torch_cases import rwkv_decay_bits_report, ulp_distance
    for dt in (torch.float32, torch.bfloat16):
        a = torch.tensor([1.0, -2.0, 0.0, 1e-3], dtype=dt)
        b = torch.nextafter(a, torch.full_like(a, 10.0))
        assert ulp_distance(a, b).tolist() == [1, 1, 1, 1]
        assert ulp_distance(torch.tensor([-0.0], dtype=dt),
                            torch.tensor([0.0], dtype=dt)).tolist() == [0]
    cfg = t_get_config("rwkv6-7b").reduced()
    params = rwkv6.serve_params(api.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), cfg, "cpu")
    x = torch.randn((2, 8, cfg.d_model)).to(torch.bfloat16)
    rep = rwkv_decay_bits_report(next(rwkv6._layers(params))[1], x, "cpu")
    assert {v["differ"] for v in rep.values()} == {0}
    assert rep["decay"]["n"] == 2 * 8 * cfg.d_model
