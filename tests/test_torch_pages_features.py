"""The page-pool plumbing of the KV-cache features against the JAX package's
``serve/pages.py`` on the same numpy inputs: the gather discipline's dense
view and one-token writeback, the insert of a prefilled request into a
quantized pool, the prefix seed, the copy-on-write page copy, and the
per-token byte figures of quantized pools.  bf16, int8 and fp8 pools in the
split-brain layout ``(L, num_pages, page_size, Hkv, hd)`` (2 layers, 3
slots, 2 KV heads of 16, ``max_len`` 32, pages of 8); the lm family's list
layout is covered by the engine tests.  Pools compare bit for bit on every
page but the scratch page 0, which holds garbage by contract.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package
import jax.numpy as jnp

from repro.configs import get_config
from repro.core.splitbrain import TrafficMeter as JMeter
from repro.models import api as japi
from repro.models import layers as JL
from repro.serve import pages as jpages
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.quant import QuantizedLeaf
from repro_torch.core.splitbrain import TrafficMeter
from repro_torch.models import api as tapi
from repro_torch.models import layers as L
from repro_torch.serve import pages
from repro_torch.serve.engine import ServeEngine

NL, B, HKV, S, HD, PS = 2, 3, 2, 32, 16, 8
N = B * S // PS + 1
BA = {"k": 1, "v": 1, "len": 0}
SA = {"k": 3, "v": 3, "len": -1}
KV = ["bf16", "int8", "fp8"]


def _like_jax():
    shape = (NL, B, HKV, S, HD)
    return {"k": jax.ShapeDtypeStruct(shape, jnp.bfloat16),
            "v": jax.ShapeDtypeStruct(shape, jnp.bfloat16),
            "len": jax.ShapeDtypeStruct((B,), jnp.int32)}


def _like_torch(batch=B):
    meta = torch.device("meta")
    shape = (NL, batch, HKV, S, HD)
    return {"k": torch.empty(shape, dtype=torch.bfloat16, device=meta),
            "v": torch.empty(shape, dtype=torch.bfloat16, device=meta),
            "len": torch.empty((batch,), dtype=torch.int32, device=meta)}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    if a.dtype.itemsize == 1 and a.dtype != np.int8:     # fp8
        return torch.from_numpy(np.array(a.view(np.uint8))).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _bytes(x):
    """A pool leaf's codes (or values) and scales as numpy bytes."""
    if isinstance(x, QuantizedLeaf):
        return (L.byte_view(x.codes).numpy(), x.scales.numpy())
    if isinstance(x, torch.Tensor):
        return (x.float().numpy(),)
    if isinstance(x, jpages.QuantizedLeaf):
        c = np.asarray(x.codes)
        return (c.view(np.uint8) if c.dtype != np.int8 else c,
                np.asarray(x.scales))
    return (np.asarray(x.astype(jnp.float32)),)


def assert_pools_equal(ours, ref):
    """Every page but scratch (page axis 1 of the split-brain layout)."""
    for name in ("k", "v"):
        for a, b in zip(_bytes(ours[name]), _bytes(ref[name])):
            np.testing.assert_array_equal(a[:, 1:], b[:, 1:], err_msg=name)


def random_pools(kv, seed=0):
    """The same pool in both packages: every page holds quantized random
    values (or bf16 ones), ``len`` per slot."""
    rng = np.random.default_rng(seed)
    ref = jpages.make_pool(_like_jax(), BA, SA, N, PS, kv_dtype=kv)
    for name in ("k", "v"):
        x = (rng.standard_normal((NL, N, PS, HKV, HD)) * 2).astype(np.float32)
        if kv == "bf16":
            ref[name] = jnp.asarray(x).astype(jnp.bfloat16)
            continue
        sc = JL.kv_pow2_scale(jnp.asarray(np.abs(x).max(axis=(2, 4))), kv)
        ref[name] = jpages.QuantizedLeaf(
            JL.kv_quantize(jnp.asarray(x), sc[:, :, None, :, None], kv), sc,
            kv, "bfloat16")
    ref["len"] = jnp.asarray([19, 0, 30], jnp.int32)
    ours = {}
    for name in ("k", "v"):
        r = ref[name]
        ours[name] = (_to_torch(r) if kv == "bf16" else QuantizedLeaf(
            _to_torch(r.codes), _to_torch(r.scales), kv, torch.bfloat16))
    ours["len"] = _to_torch(ref["len"])
    return ref, ours


TABLE = np.array([[3, 7, 1, 0], [0, 0, 0, 0], [12, 2, 9, 5]], np.int32)


@pytest.mark.parametrize("kv", KV)
def test_gather_tree_bit_identical(kv):
    ref, ours = random_pools(kv)
    rv = jax.jit(lambda p, t: jpages.gather_tree(p, t, BA, SA))(
        ref, jnp.asarray(TABLE))
    ov = pages.gather_tree(ours, torch.from_numpy(TABLE), BA, SA)
    for name in ("k", "v"):
        assert ov[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(ov[name].float().numpy(),
                                      np.asarray(rv[name].astype(jnp.float32)))
        # laid out as a dense slot cache: the dense token step reads it with
        # the slot cache's kernels (a strided view can take another GEMM
        # algorithm on the card, and part from the dense cache's tokens)
        assert ov[name].is_contiguous()
        assert ov[name].shape == (NL, B, HKV, S, HD)
    assert ov["len"] is ours["len"]          # dense leaves pass through


@pytest.mark.parametrize("kv", KV)
def test_scatter_token_tree_bit_identical(kv):
    """The gather discipline's writeback: each active slot's token at its
    position goes into its page (a quantized page is requantized), an
    inactive slot's lands on scratch."""
    ref, ours = random_pools(kv, seed=1)
    rng = np.random.default_rng(2)
    pos = np.array([19, 8, 30], np.int32)
    write = np.array([True, False, True])
    table = jnp.asarray(TABLE)
    view = jpages.gather_tree(ref, table, BA, SA)
    for name in ("k", "v"):
        tok = rng.standard_normal((NL, B, HKV, HD)).astype(np.float32) * 3
        view[name] = view[name].at[:, jnp.arange(B), :, pos].set(
            jnp.asarray(tok).astype(jnp.bfloat16).transpose(1, 0, 2, 3))
    rp = jax.jit(lambda p, v, t, q, w: jpages.scatter_token_tree(
        p, v, t, q, w, BA, SA))(ref, view, table, jnp.asarray(pos),
                                jnp.asarray(write))
    tv = {name: _to_torch(view[name]) for name in ("k", "v")}
    tv["len"] = ours["len"]
    pages.scatter_token_tree(ours, tv, torch.from_numpy(TABLE),
                             torch.from_numpy(pos), torch.from_numpy(write),
                             BA, SA)
    assert_pools_equal(ours, rp)


@pytest.mark.parametrize("kv", KV)
def test_insert_tree_bit_identical(kv):
    """A prefilled B=1 request of 19 tokens into slot 2, whose first table
    entry is a matched prefix page (redirected to scratch): a quantized
    pool zeroes the positions past the prompt before each page's scale."""
    ref, ours = random_pools(kv, seed=3)
    rng = np.random.default_rng(4)
    single = {name: jnp.asarray(rng.standard_normal((NL, 1, HKV, S, HD))
                                * 2).astype(jnp.bfloat16)
              for name in ("k", "v")}
    single["len"] = jnp.asarray([19], jnp.int32)
    row = np.array([0, 2, 9, 0], np.int32)
    rp = jax.jit(lambda p, s1, r, n: jpages.insert_tree(
        p, s1, r, jnp.int32(2), BA, SA, n_tokens=n))(
        ref, single, jnp.asarray(row), jnp.int32(19))
    pages.insert_tree(ours, {k: _to_torch(v) for k, v in single.items()},
                      torch.from_numpy(row), 2, BA, SA, n_tokens=19)
    assert_pools_equal(ours, rp)
    np.testing.assert_array_equal(ours["len"].numpy(), np.asarray(rp["len"]))


class _JHost(jpages.PagedEngineMixin):
    def __init__(self, kv):
        self._pager = jpages.HostPager(PS, None, S)
        self._pager.reset(B)
        self._paging_active = True
        self.meter, self.max_len, self.page_size = JMeter(), S, PS
        self._kv_dtype = kv
        self._kv_tok_bytes = jpages.kv_token_bytes(_like_jax(), BA, SA)
        self._kv_quant_tok_bytes = (
            jpages.kv_token_bytes_quant(_like_jax(), BA, SA, PS, kv)
            if kv != "bf16" else None)


class _Host(pages.PagedEngineMixin):
    def __init__(self, kv):
        self._pager = pages.HostPager(PS, None, S, device="cpu")
        self._pager.reset(B)
        self.meter, self.max_len, self.page_size = TrafficMeter(), S, PS
        self.device = torch.device("cpu")
        self._kv_dtype = kv
        self._note_slot_cache(B, _like_torch(), BA, SA)


@pytest.mark.parametrize("kv", KV)
def test_paged_seed_and_cow_copy_bit_identical(kv):
    """Slot 1 maps slot 0's two published pages (a whole-body prefix hit):
    the seed gathers (dequantizes) them into a B=1 cache with ``len`` set;
    the copy-on-write copy moves a page's codes with its scales, and meters
    ``page_cow_copy`` in the pool's storage format."""
    ref, ours = random_pools(kv, seed=5)
    hosts = (_JHost(kv), _Host(kv))
    prompt = np.arange(1, 17, dtype=np.int32)
    for h in hosts:
        pool = h._pager.pool
        assert pool.try_admit(0, 20)
        pool.ensure(0, 17)
        pool.publish(0, prompt, 16)
        assert pool.try_admit(1, 20, matched=pool.match_prefix(prompt),
                              extra_new=1)
    np.testing.assert_array_equal(hosts[0]._pager.pool.table,
                                  hosts[1]._pager.pool.table)
    b1 = {k: jax.ShapeDtypeStruct((NL, 1) + v.shape[2:], v.dtype)
          if k != "len" else jax.ShapeDtypeStruct((1,), jnp.int32)
          for k, v in _like_jax().items()}
    rs = hosts[0].paged_seed(ref, 1, 15, BA, SA, b1)
    os_ = hosts[1].paged_seed(ours, 1, 15, BA, SA, _like_torch(1))
    for name in ("k", "v"):
        np.testing.assert_array_equal(os_[name].float().numpy(),
                                      np.asarray(rs[name].astype(jnp.float32)))
    assert os_["len"].tolist() == [15] == np.asarray(rs["len"]).tolist()
    src = int(hosts[0]._pager.pool.table[1, 1])
    copies = [(src, 11)]
    rc = hosts[0].apply_cow_copies(ref, copies, BA, SA)
    hosts[1].apply_cow_copies(ours, copies, BA, SA)
    assert_pools_equal(ours, rc)
    assert hosts[1].meter.host_log == hosts[0].meter.host_log
    assert hosts[1].meter.host_log[-1][0] == "page_cow_copy"


ARCHS = ["llama2-7b", "gemma2-27b", "tinyllama-1.1b"]


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_kv_token_bytes_quant_matches_reference(arch, full, kv):
    """Bytes per stored token of a quantized pool (1-byte codes plus the
    per-page scales spread over 16 positions), from the ServeEngine's cache
    layout (found by shape alone): only the paging leaves count (gemma2's
    rings do not), at reduced and full width; and a pool made with it holds
    exactly that many bytes per token position."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if not full:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    max_len = 1024 if full else 64
    ns = SimpleNamespace(cfg=cfg, max_len=max_len, page_size=16, _axes=None,
                         _seq_ax=None)
    shape = jax.eval_shape(lambda: japi.init_cache(cfg, 2, max_len))
    want = jpages.kv_token_bytes_quant(shape, JEngine._slot_axes(ns),
                                       JEngine._slot_seq_axes(ns), 16, kv)
    eng = ServeEngine.__new__(ServeEngine)
    eng.cfg, eng.max_len = tcfg, max_len
    tsa = eng._slot_seq_axes(16)
    like = tapi.init_cache(tcfg, 2, max_len, device=torch.device("meta"))
    tba = tapi.family_module(tcfg).BATCH_AXES
    got = pages.kv_token_bytes_quant(like, tba, tsa, 16, kv)
    assert got == want
    if not full:
        pool = pages.make_pool(like, tba, tsa, 9, 16, "cpu", kv_dtype=kv)
        assert pages.pool_bytes(pool, tsa) == 9 * 16 * got
