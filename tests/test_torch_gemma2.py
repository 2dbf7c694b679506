"""gemma2 on the port's ServeEngine against the JAX package's, on the same
weights.

Reduced gemma2-27b: 2 layers, a local layer with a 16-token window beside a
global one, GQA 4/2, head_dim 16, vocab 256, tied embeddings, attention
softcap 50 and final softcap 30; ``max_len`` 64, page size 8.  Its local
layer keeps a slot-private dense ring of 16 positions, its global layer
pages.  The reference runs on an Auto-axis mesh with ``use_pallas=True``.

Under each package's scheduler (two slots, so slots turn over) four
prompts of 5, 12, 17 and 30 tokens decode 12 tokens each: the first three
fit the ring and take the block prefill (17 tokens fill it exactly), the
last is longer than the window and takes the per-token prefill; the decode
of the 12-token prompt wraps its ring.  Tokens, page tables after every
iteration and the eq. 7-10 meter log must be identical.  ``generate()``
runs prompts inside and beyond the window, fused and stepwise, with and
without ``eos_id``.  Logits of the prefill and of decode steps across the
ring's wrap are bit-identical to the reference's jitted programs, and
both softcaps are shown to act.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve import pages as jpages
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.splitbrain import TrafficModel
from repro_torch.models import api, transformer
from repro_torch.models.api import params_from_numpy
from repro_torch.serve import pages as tpages
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

ARCH = "gemma2-27b"
LENS = [5, 12, 17, 30]
MAX_NEW = 12
MAX_LEN = 64
WINDOW = 16


def _requests(cls):
    return [cls(uid=i, prompt=((np.arange(1, n + 1) * 7 + i) % 256)
                .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate(LENS)]


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), use_pallas=True)
    tcfg = t_get_config(ARCH).reduced()
    assert [s.window for s in tcfg.layer_pattern] == [WINDOW, None]
    assert tcfg.tie_embeddings and tcfg.softcap == 50.0
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(2))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                mesh=mesh, engines=None)


def _ref_engine(s, **kw):
    return JEngine(s["cfg"], s["params"], mesh=s["mesh"], max_len=MAX_LEN,
                   **kw)


def _port_engine(s, **kw):
    return ServeEngine(s["tcfg"], s["tparams"], max_len=MAX_LEN, device="cpu",
                       **kw)


@pytest.mark.parametrize("page_size", [8, None], ids=["paged", "dense"])
def test_scheduler_tokens_tables_and_meter_match_reference(setup, page_size):
    ref = _ref_engine(setup, page_size=page_size)
    ours = _port_engine(setup, page_size=page_size)
    scheds = (JScheduler(ref, max_slots=2),
              ContinuousBatchingScheduler(ours, max_slots=2))
    for s, cls in zip(scheds, (JRequest, Request)):
        s.begin()
        for r in _requests(cls):
            assert s.submit(r)
    steps = 0
    while any(s.has_work() for s in scheds):
        for s in scheds:
            s.step()
        steps += 1
        if page_size is not None:
            np.testing.assert_array_equal(ref._pager.pool.table,
                                          ours._pager.pool.table,
                                          err_msg=f"iteration {steps}")
        assert steps < 200
    toks = []
    for s in scheds:
        res = sorted(s.poll(), key=lambda r: r.uid)
        assert [r.state for r in res] == ["DONE"] * len(LENS)
        toks.append([r.tokens.tolist() for r in res])
    assert toks[1] == toks[0]
    assert [len(t) for t in toks[1]] == [MAX_NEW] * len(LENS)
    n_tok = sum(n - 1 for n in LENS) + MAX_NEW * len(LENS)
    bpt = TrafficModel.for_config(setup["tcfg"]).bytes_per_token()
    assert ours.measured_bytes()["total"] == bpt * n_tok
    assert ours.meter.log == ref.meter.log
    assert ours.meter.host_log == ref.meter.host_log
    cache = scheds[1].cache
    # the local layer's ring is dense and slot-private, the global one pages
    assert tuple(cache["k"][0].shape) == (1, 1, 2, 2, WINDOW, 16)
    if page_size is not None:
        assert ours._sa["k"] == [-1, 4]
        assert tuple(cache["k"][1].shape[2:4]) == (2 * MAX_LEN // 8 + 1, 8)
        assert ours._pager.pool.pages_in_use == 0
        stats = ours.cache_stats(cache)
        # pool bytes count the global layer's K/V only
        assert stats["page_bytes"] == 8 * 2 * (2 * 16 * 2)


@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
@pytest.mark.parametrize("T0", [12, 24], ids=["in_window", "past_window"])
def test_generate_matches_reference(setup, T0, fused, with_eos):
    """Prompts inside the window take the block prefill, prompts past it
    the per-token one; the decode wraps the ring either way."""
    prompts = np.stack([((np.arange(1, T0 + 1) * (5 + i) + 3 * i) % 256)
                        for i in range(3)]).astype(np.int32)
    if setup["engines"] is None:     # shared: the reference compiles once
        setup["engines"] = (_ref_engine(setup), _port_engine(setup))
    ref, ours = setup["engines"]
    ours.meter.reset()
    eos = None
    if with_eos:   # a token some rows emit after their first and others never
        base = ours.generate(prompts, max_new=MAX_NEW)["tokens"]
        eos = next(int(t) for t in base[:, 1:].ravel()
                   if not (base == t).any(axis=1).all())
        ours.meter.reset()
    a = ref.generate(prompts, max_new=MAX_NEW, fused=fused, eos_id=eos)
    b = ours.generate(prompts, max_new=MAX_NEW, fused=fused, eos_id=eos)
    np.testing.assert_array_equal(b["tokens"], np.asarray(a["tokens"]))
    np.testing.assert_array_equal(b["gen_len"], np.asarray(a["gen_len"]))
    if with_eos:
        assert b["gen_len"].min() < MAX_NEW
    n_tok = 3 * (T0 - 1) + int(b["gen_len"].sum())
    bpt = TrafficModel.for_config(setup["tcfg"]).bytes_per_token()
    assert ours.measured_bytes()["total"] == bpt * n_tok


def _jit_logits(s, prompts, steps, block):
    """The reference's jitted programs: the prompt body through its block
    prefill (``block``) or one decode step per token, then ``steps``
    greedy decode steps; the logits of every decode step, and the
    prefill's."""
    cfg = s["cfg"]
    with s["mesh"]:
        jc = japi.init_cache(cfg, prompts.shape[0], MAX_LEN)
        step = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cfg))
        if block:
            jl, jc = jax.jit(lambda p, c, t: japi.prefill(p, c, t, cfg))(
                s["params"], jc, jnp.asarray(prompts[:, :-1]))
        else:
            for t in range(prompts.shape[1] - 1):
                jl, jc = step(s["params"], jc, jnp.asarray(prompts[:, t]))
        out = [np.asarray(jl)]
        tok = jnp.asarray(prompts[:, -1])
        for _ in range(steps):
            jl, jc = step(s["params"], jc, tok)
            out.append(np.asarray(jl))
            tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    return out


def _port_logits(params, cfg, prompts, steps, block=True):
    tc = api.init_cache(cfg, prompts.shape[0], MAX_LEN, device="cpu")
    body = torch.from_numpy(prompts[:, :-1])
    if block:
        tl, tc = api.prefill(params, tc, body, cfg)
    else:
        for t in range(body.shape[1]):
            tl, tc = api.decode_step(params, tc, body[:, t], cfg)
    out = [tl]
    tok = torch.from_numpy(prompts[:, -1])
    for _ in range(steps):
        tl, tc = api.decode_step(params, tc, tok, cfg)
        out.append(tl)
        tok = torch.argmax(tl, dim=-1).to(torch.int32)
    return out, tc


def test_decode_logits_bit_identical_across_ring_wrap(setup):
    """A 14-token prompt fed one decode step per token, then eight greedy
    decode steps from position 13 to 20, past the ring's 16 positions:
    every logit has the bits of the reference's jitted decode step."""
    prompts = np.stack([((np.arange(1, 15) * (3 + i)) % 256)
                        for i in range(2)]).astype(np.int32)
    ours = _port_engine(setup)
    ref = _jit_logits(setup, prompts, 8, block=False)
    got, cache = _port_logits(ours.params, ours.cfg, prompts, 8, block=False)
    assert cache["len"].tolist() == [21, 21]
    assert tuple(cache["k"][0].shape[4:]) == (WINDOW, 16)
    for t, (o, r) in enumerate(zip(got, ref)):
        assert o.dtype == torch.float32
        np.testing.assert_array_equal(o.numpy(), r, err_msg=f"step {t}")


def test_block_prefill_logits_within_one_ulp(setup):
    """The block prefill's last-position logits, then decode steps across
    the wrap, against the reference's jitted prefill and decode: within
    one bf16 ulp of the largest |logit|, with the same argmax.  (The
    reference's Pallas flash kernel, run in interpret mode with a window,
    differs from the window-free one in a last float32 bit of some sums;
    a few of its bf16 outputs then differ by one ulp, and the port
    follows the window-free one.)"""
    prompts = np.stack([((np.arange(1, 15) * (3 + i)) % 256)
                        for i in range(2)]).astype(np.int32)
    ours = _port_engine(setup)
    ref = _jit_logits(setup, prompts, 8, block=True)
    got, _ = _port_logits(ours.params, ours.cfg, prompts, 8)
    for o, r in zip(got, ref):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=ulp)
        np.testing.assert_array_equal(o.argmax(-1).numpy(), r.argmax(-1))


def test_softcaps_act_and_bound_the_logits(setup):
    """Turning off the attention softcap or the final softcap changes the
    logits; with both on every logit lies within the final cap 30."""
    prompts = np.stack([((np.arange(1, 14) * (3 + i)) % 256)
                        for i in range(2)]).astype(np.int32)
    tcfg = setup["tcfg"]
    runs = {}
    for name, cfg in (("both", tcfg),
                      ("no_softcap", dataclasses.replace(tcfg, softcap=None)),
                      ("no_final", dataclasses.replace(tcfg,
                                                       final_softcap=None))):
        params = transformer.serve_params(setup["tparams"], cfg, "cpu")
        runs[name] = torch.stack(_port_logits(params, cfg, prompts, 4)[0])
    assert runs["both"].abs().max() <= 30.0
    assert not torch.equal(runs["both"], runs["no_softcap"])
    assert not torch.equal(runs["both"], runs["no_final"])
    # the final cap is tanh-shaped: it only shrinks magnitudes
    assert runs["no_final"].abs().max() > runs["both"].abs().max()


def test_tied_head_reads_the_rounded_embedding_without_copying_it(setup):
    """``serve_params`` rounds the tied embedding to bf16 once (kept
    float32, the same bits as the reference's cast-at-use), and a decode
    step makes no tensor the size of the embedding: the head reads it in
    place."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    ours = _port_engine(setup)
    embed = ours.params["embed"]
    assert embed.dtype == torch.float32
    assert torch.equal(embed, embed.to(torch.bfloat16).to(torch.float32))
    raw = setup["tparams"]["embed"]
    assert not torch.equal(raw, embed)       # the raw table was not rounded

    class Sizes(TorchDispatchMode):
        """The largest tensor an op allocates (views of its inputs aside)."""

        def __init__(self):
            super().__init__()
            self.largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen = {t.untyped_storage().data_ptr()
                    for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor)}
            for t in tree_flatten(out)[0]:
                if (isinstance(t, torch.Tensor)
                        and t.untyped_storage().data_ptr() not in seen):
                    self.largest = max(self.largest, t.numel())
            return out

    cache = api.init_cache(ours.cfg, 2, MAX_LEN, device="cpu")
    with Sizes() as sizes:
        api.decode_step(ours.params, cache, torch.tensor([3, 4]), ours.cfg)
    assert 0 < sizes.largest < embed.numel()


@pytest.mark.parametrize("arch,want", [
    ("gemma2-27b", {"k": [-1, 4], "v": [-1, 4], "len": -1}),
    ("llama2-7b", {"k": [4], "v": [4], "len": -1}),
    ("rwkv6-7b", {"wkv": -1, "x_tm": -1, "x_cm": -1, "len": -1})])
def test_seq_axes_discovery(arch, want):
    """Which cache leaves page, found by diffing two ``max_len`` builds:
    gemma2 mixes a window-capped ring (-1) with a paging global layer,
    llama2-7b pages every K/V leaf, rwkv6-7b none.  The full configs are
    built on the meta device; the reduced ones equal the JAX package's
    discovery leaf for leaf."""
    meta = torch.device("meta")
    full = t_get_config(arch)
    got = tpages.seq_axes(api.init_cache(full, 2, 8192, device=meta),
                          api.init_cache(full, 2, 8192 + 16, device=meta), 16)
    assert got == want
    cfg, tcfg = get_config(arch).reduced(), t_get_config(arch).reduced()
    ref = jpages.seq_axes(
        jax.eval_shape(lambda: japi.init_cache(cfg, 2, MAX_LEN)),
        jax.eval_shape(lambda: japi.init_cache(cfg, 2, MAX_LEN + 8)), 8)
    ours = tpages.seq_axes(api.init_cache(tcfg, 2, MAX_LEN, device=meta),
                           api.init_cache(tcfg, 2, MAX_LEN + 8, device=meta),
                           8)
    assert ours == ref == want


def test_softcap_tanh_is_xla_s_bit_for_bit():
    """``kernels/ref.py::tanh``, the softcaps' tanh, has the bits of the
    reference's jitted ``jnp.tanh`` on the CPU over six decades, where
    ``torch.tanh`` differs in the last place on most values."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(100_000).astype(np.float32) * s
                        for s in (1e-4, 0.01, 0.3, 1.0, 4.0, 20.0)])
    want = np.asarray(jax.jit(jnp.tanh)(jnp.asarray(x)))
    got = ref.tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (torch.tanh(torch.from_numpy(x)).numpy() != want).mean() > 0.3
