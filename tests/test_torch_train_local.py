"""The port's training pieces that need no JAX: remat, the kernels'
autograd Functions and the wrappers' refusal of gradients, and the
training CLI, on the CPU.

* ``remat`` "full" and "dots" give the loss and every gradient of "none"
  bit for bit, in every family's forward (the recomputation repeats the
  same ops on the CPU).
* ``FlashAttentionFn`` / ``RWKV6ScanFn``: their forward is the kernel's
  and their backward the plain version's autograd on the saved inputs.
  Here the CUDA wrapper is replaced by its plain version (the CPU has no
  card), so the Function's gradients must equal the plain autograd's bit
  for bit; ``tests/test_torch_gpu.py`` holds the real kernels so.
* The four kernel wrappers raise in grad mode on an operand that requires
  grad; ``ops`` on CPU tensors differentiates the plain version as it is.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import rwkv_scan as krw
from repro_torch.kernels import w4a8_matmul as kw
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.train import optimizer as topt
from torch_cases import autograd_grads, paged_case, rwkv_case, w4a8_case

REMAT_ARCHS = ("stablelm-1.6b", "gemma2-27b", "phi3.5-moe-42b-a6.6b",
               "rwkv6-7b", "hymba-1.5b", "llama-3.2-vision-11b",
               "seamless-m4t-medium")


def _loss_and_grads(cfg, params, batch):
    flat = [t for _, t in topt.leaves(params)]
    total, _ = api.loss_fn(params, batch, cfg)
    return total, torch.autograd.grad(total, flat)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_is_bit_identical_to_none(arch):
    cfg = get_config(arch).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.cross_attn_every:
        params["cross"]["gate"] = torch.tensor([0.7, -0.9])
    for _, t in topt.leaves(params):
        t.requires_grad_(True)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.frontend_tokens:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    runs = {mode: _loss_and_grads(dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, remat=mode)),
        params, batch) for mode in ("none", "full", "dots")}
    base_loss, base_grads = runs["none"]
    for mode in ("full", "dots"):
        loss, grads = runs[mode]
        assert torch.equal(loss, base_loss), mode
        for a, b in zip(grads, base_grads):
            assert torch.equal(a, b), mode


def test_remat_rejects_an_unknown_mode():
    from repro_torch.models.layers import remat
    with pytest.raises(ValueError, match="remat"):
        remat(lambda x: x, "some")


# ----------------------------------------------------------------------------
# the autograd Functions
# ----------------------------------------------------------------------------
def _attention_case(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((2, 4, 9, 16), generator=g).to(dtype)
    k = torch.randn((2, 2, 9, 16), generator=g).to(dtype)
    v = torch.randn((2, 2, 9, 16), generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw_", [dict(causal=True),
                                 dict(causal=True, window=4, softcap=30.0),
                                 dict(causal=False)])
def test_flash_function_gradients_are_the_plain_versions(monkeypatch, dtype,
                                                         kw_):
    """The Function's backward is the plain version's autograd; its forward
    calls the wrapper (here the plain version in the wrapper's place) once,
    and the backward launches nothing."""
    calls = []

    def fake(q, k, v, **kw):
        calls.append(1)
        return ref.flash_attention(q, k, v, **kw)

    monkeypatch.setattr(kfa, "flash_attention", fake)
    q, k, v = _attention_case(dtype=dtype)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)
                       ).to(dtype)
    full = dict(kw_, scale=None, kv_offset=0, window=kw_.get("window"),
                softcap=kw_.get("softcap"))
    out_f, g_f = autograd_grads(
        lambda *x: kfa.FlashAttentionFn.apply(*x, full), (q, k, v), dout)
    assert len(calls) == 1
    out_r, g_r = autograd_grads(lambda *x: ref.flash_attention(*x, **kw_),
                                (q, k, v), dout)
    assert torch.equal(out_f[0], out_r[0])
    for a, b in zip(g_f, g_r):
        assert a.dtype == dtype and torch.equal(a, b)
    assert len(calls) == 1


def test_rwkv_function_gradients_are_the_plain_versions(monkeypatch):
    """Gradients through the output and the final state alike, and through
    the output alone (the state's gradient absent)."""
    monkeypatch.setattr(krw, "rwkv6_scan",
                        lambda r, k, v, w, u: ref.rwkv6_scan(r, k, v, w, u))
    r, k, v, w, u = (torch.from_numpy(a) for a in rwkv_case(2, 2, 7, 16))
    g = torch.Generator().manual_seed(3)
    dout = torch.randn(r.shape, generator=g)
    dstate = torch.randn((2, 2, 16, 16), generator=g)
    for douts in ((dout, dstate), (dout, None)):
        out_f, g_f = autograd_grads(krw.RWKV6ScanFn.apply, (r, k, v, w, u),
                                    douts)
        out_r, g_r = autograd_grads(ref.rwkv6_scan, (r, k, v, w, u), douts)
        for a, b in zip(out_f + g_f, out_r + g_r):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_functions_under_remat(monkeypatch, mode):
    """The Functions inside a checkpointed layer (remat): the recomputation
    runs their forward again and their backward unpacks the saved inputs
    once, as a non-reentrant checkpoint requires; the gradients are the
    plain version's."""
    from repro_torch.models.layers import remat
    monkeypatch.setattr(kfa, "flash_attention",
                        lambda q, k, v, **kw: ref.flash_attention(q, k, v,
                                                                  **kw))
    monkeypatch.setattr(krw, "rwkv6_scan",
                        lambda r, k, v, w, u: ref.rwkv6_scan(r, k, v, w, u))
    q, k, v = _attention_case()
    kw_ = dict(causal=True, window=None, softcap=None, scale=None,
               kv_offset=0)

    def layer(q, k, v):
        return kfa.FlashAttentionFn.apply(q * 1.5, k, v, kw_).sin()

    dout = torch.ones_like(q)
    _, g_f = autograd_grads(remat(layer, mode), (q, k, v), dout)
    _, g_r = autograd_grads(lambda q, k, v: ref.flash_attention(
        q * 1.5, k, v, causal=True).sin(), (q, k, v), dout)
    for a, b in zip(g_f, g_r):
        assert torch.equal(a, b)
    ins = tuple(torch.from_numpy(a) for a in rwkv_case(1, 2, 6, 16))
    _, g_f = autograd_grads(
        remat(lambda *x: krw.RWKV6ScanFn.apply(*x)[0] * 2.0, mode), ins,
        torch.ones_like(ins[0]))
    _, g_r = autograd_grads(lambda *x: ref.rwkv6_scan(*x)[0] * 2.0, ins,
                            torch.ones_like(ins[0]))
    for a, b in zip(g_f, g_r):
        assert torch.equal(a, b)


def test_ops_on_cpu_differentiate_the_plain_versions():
    q, k, v = _attention_case()
    dout = torch.ones_like(q)
    out_o, g_o = autograd_grads(lambda *x: ops.attention(*x, window=5),
                                (q, k, v), dout)
    out_r, g_r = autograd_grads(lambda *x: ref.flash_attention(*x, window=5),
                                (q, k, v), dout)
    for a, b in zip(out_o + g_o, out_r + g_r):
        assert torch.equal(a, b)
    r, kk, vv, w, u = (torch.from_numpy(a) for a in rwkv_case(1, 2, 5, 16))
    out_o, g_o = autograd_grads(ops.rwkv6, (r, kk, vv, w, u),
                                (torch.ones_like(r), None))
    out_r, g_r = autograd_grads(ref.rwkv6_scan, (r, kk, vv, w, u),
                                (torch.ones_like(r), None))
    for a, b in zip(out_o + g_o, out_r + g_r):
        assert torch.equal(a, b)
    x = q.requires_grad_(True)
    assert "FlashAttentionFn" not in type(
        ops.attention(x, k, v).grad_fn).__name__


def _wrapper_calls():
    q, k, v = _attention_case()
    r, kk, vv, w, u = (torch.from_numpy(a) for a in rwkv_case(1, 2, 5, 16))
    qx, xs, codes, ws = (torch.from_numpy(a) for a in w4a8_case(2, 32, 16))
    pc = paged_case(0)
    return {
        "flash_attention": (lambda g: kfa.flash_attention(
            q.requires_grad_(g), k, v)),
        "rwkv6_scan": (lambda g: krw.rwkv6_scan(
            r, kk, vv, w, u.requires_grad_(g))),
        "w4a8_matmul": (lambda g: kw.w4a8_matmul(
            qx, xs.requires_grad_(g), codes, ws)),
        "paged_decode_attention": (lambda g: kpa.paged_decode_attention(
            pc["q"].requires_grad_(g), pc["k"], pc["v"], pc["table"],
            pc["lens"]))}


@pytest.mark.parametrize("name", sorted(ops.KERNELS))
def test_kernel_wrappers_refuse_an_operand_that_requires_grad(name):
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call(True)
    # outside grad mode the wrapper goes on to its own checks (a CPU
    # tensor is refused there)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        call(True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        call(False)


def test_refuse_grad_ignores_absent_operands():
    build.refuse_grad("x", None, torch.zeros(2))
    with pytest.raises(RuntimeError):
        build.refuse_grad("x", None, torch.zeros(2, requires_grad=True))


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------
def test_train_cli_runs_on_the_cpu_and_its_loss_falls(capsys):
    out = train_cli.main(["--arch", "stablelm-1.6b", "--smoke", "--device",
                          "cpu", "--steps", "8"])
    assert out["steps"] == 8
    assert out["last_loss"] < out["first_loss"] - 0.5
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("step     0 loss ")
    assert "med_step" in lines[0] and "stragglers" in lines[0]
    assert lines[-1].startswith('{"first_loss"')


def test_train_cli_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "stablelm-1.6b", "--smoke", "--steps", "1"])
