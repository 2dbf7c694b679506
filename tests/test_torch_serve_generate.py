"""The port's ServeEngine.generate and its model functions against the JAX
package's, on the same weights.

Reduced llama2-7b and tinyllama-1.1b as in ``test_torch_serve_engine.py``.
``generate()`` fused (one block prefill, then the decode loop) and stepwise
(one decode step per token), with and without an ``eos_id`` that stops some
rows early: tokens and ``gen_len`` identical to the reference's
``generate()`` with ``use_pallas=True``, and the meter exact.

Logits: the reference's programs are all compiled, and the port rounds to
bf16 where they round (XLA keeps the LM head's product and the FFN
pre-norm's residual sum in float32; the port does too), so on this CPU the
prefill's last-position logits and a decode step's logits are bit-identical
to the reference's jitted ones.  They are held to one bf16 ulp of the
largest |logit|, the step a last-bit difference in a float sum's order
could move them, and to the same argmax.
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
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.splitbrain import TrafficModel
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine

ARCHS = ["llama2-7b", "tinyllama-1.1b"]
MAX_LEN = 64
MAX_NEW = 8


def _prompts(B=3, T0=9):
    return np.stack([((np.arange(1, T0 + 1) * (5 + i) + 3 * i) % 256)
                     .astype(np.int32) for i in range(B)])


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(1))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ref = JEngine(cfg, params, mesh=mesh, max_len=MAX_LEN)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    ours = ServeEngine(t_get_config(arch).reduced(), tparams,
                       max_len=MAX_LEN, device="cpu")
    base = ref.generate(_prompts(), max_new=MAX_NEW)["tokens"]
    # a stop token that some rows emit mid-way and others never do
    eos = next(int(t) for t in base[:, 1:].ravel()
               if not (base == t).any(axis=1).all())
    return dict(arch=arch, cfg=cfg, mesh=mesh, ref=ref, ours=ours, eos=eos)


@pytest.mark.parametrize("with_eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stepwise"])
def test_generate_tokens_and_gen_len_identical(setup, fused, with_eos):
    ref, ours = setup["ref"], setup["ours"]
    eos = setup["eos"] if with_eos else None
    prompts = _prompts()
    ours.meter.reset()
    a = ref.generate(prompts, max_new=MAX_NEW, fused=fused, eos_id=eos)
    b = ours.generate(prompts, max_new=MAX_NEW, fused=fused, eos_id=eos)
    np.testing.assert_array_equal(b["tokens"], a["tokens"])
    np.testing.assert_array_equal(b["gen_len"], a["gen_len"])
    if with_eos:
        assert b["gen_len"].min() < MAX_NEW     # the stop token fired
    n_tok = prompts.shape[0] * (prompts.shape[1] - 1) + int(b["gen_len"].sum())
    bpt = TrafficModel.for_config(ours.cfg).bytes_per_token()
    assert ours.measured_bytes()["total"] == bpt * n_tok


def test_generate_single_token_prompt_and_oversize(setup):
    """T0 = 1 skips the prefill; a request past max_len raises."""
    prompts = _prompts(B=2, T0=1)
    a = setup["ref"].generate(prompts, max_new=4)
    b = setup["ours"].generate(prompts, max_new=4)
    np.testing.assert_array_equal(b["tokens"], a["tokens"])
    with pytest.raises(ValueError, match="does not fit"):
        setup["ours"].generate(_prompts(T0=60), max_new=8)


def test_prefill_and_decode_logits_within_one_ulp(setup):
    """Prefill's last-position logits against the reference's jitted
    prefill, then one decode step's against its jitted decode step."""
    cfg, ours = setup["cfg"], setup["ours"]
    prompts = _prompts(B=2, T0=13)
    with setup["mesh"]:
        jc = japi.init_cache(cfg, 2, MAX_LEN)
        jl, jc = jax.jit(lambda p, c, t: japi.prefill(p, c, t, cfg))(
            setup["ref"].params, jc, jnp.asarray(prompts))
        jl2, _ = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, cfg))(
            setup["ref"].params, jc, jnp.asarray(prompts[:, -1]))
    tc = api.init_cache(ours.cfg, 2, MAX_LEN, device="cpu")
    tl, tc = api.prefill(ours.params, tc, torch.from_numpy(prompts), ours.cfg)
    assert tc["len"].tolist() == [13, 13]
    tl2, tc = api.decode_step(ours.params, tc,
                              torch.from_numpy(prompts[:, -1]), ours.cfg)
    assert tc["len"].tolist() == [14, 14]
    for ours_l, ref_l in ((tl, jl), (tl2, jl2)):
        ref_l = np.asarray(ref_l)
        assert ours_l.dtype == torch.float32 and ours_l.shape == ref_l.shape
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref_l).max())) - 7)
        np.testing.assert_allclose(ours_l.numpy(), ref_l, rtol=0, atol=ulp)
        np.testing.assert_array_equal(ours_l.argmax(-1).numpy(),
                                      ref_l.argmax(-1))


def test_lockstep_and_ragged_writes_leave_the_same_cache(setup):
    """generate() writes K/V in lockstep, the slot step at ragged positions
    with inactive rows frozen: the same values where both write."""
    rng = np.random.default_rng(0)
    cache = torch.from_numpy(rng.standard_normal((3, 2, 8, 4))
                             .astype(np.float32)).to(torch.bfloat16)
    new = torch.from_numpy(rng.standard_normal((3, 2, 1, 4))
                           .astype(np.float32)).to(torch.bfloat16)
    pos = torch.tensor([5, 5, 5], dtype=torch.int32)
    a = L.cache_write(cache.clone(), new, pos, aligned=True)
    b = L.cache_write(cache.clone(), new, pos, aligned=False)
    assert torch.equal(a, b) and torch.equal(a[:, :, 5:6], new)
    write = torch.tensor([True, False, True])
    c = L.cache_write(cache.clone(), new, torch.tensor([1, 6, 7]),
                      aligned=False, write=write)
    assert torch.equal(c[1], cache[1])                  # frozen row
    assert torch.equal(c[0, :, 1], new[0, :, 0])
    assert torch.equal(c[2, :, 7], new[2, :, 0])
    c[0, :, 1], c[2, :, 7] = cache[0, :, 1], cache[2, :, 7]
    assert torch.equal(c, cache)                        # nothing else moved
