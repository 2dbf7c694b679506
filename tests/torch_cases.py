"""Seeded numpy inputs, tolerances and the teacher-forced card-vs-CPU logit
check shared by the ``test_torch_*`` files and ``chip_smoke.py``.

Imports neither JAX nor the JAX package, so the ``gpu`` tests that use it
also run on a machine with only PyTorch.
"""
import importlib.util
from pathlib import Path

import numpy as np
import torch

from repro_torch.models import api

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def load_example(name):
    """``examples/<name>.py`` as a module (the examples are scripts, not a
    package)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def w4a8_case(M, K, N, seed=0):
    """int8 activations and scales, INT4 codes and scales of a W4A8 op."""
    rng = np.random.default_rng(seed)
    qx = rng.integers(-127, 128, (M, K)).astype(np.int8)
    xs = (rng.random((M, 1)) * 0.02 + 1e-3).astype(np.float32)
    codes = rng.integers(-7, 8, (K, N)).astype(np.int8)
    ws = (rng.random((N,)) * 0.05 + 1e-3).astype(np.float32)
    return qx, xs, codes, ws


def paged_case(seed, *, B=3, Hq=4, Hkv=2, D=16, ps=8, P=4, lens=(0, 5, 29),
               dtype=torch.float32, kv=None):
    """Random q, pools, a page table with distinct pages per slot (entries
    past a slot's length point at the scratch page 0) and lengths, as CPU
    tensors.  ``kv`` = "int8" / "fp8" makes quantized pools with
    power-of-two per-(page, KV head) scales."""
    rng = np.random.default_rng(seed)
    N = B * P + 1
    q = torch.from_numpy(rng.standard_normal((B, Hq, 1, D)).astype(np.float32))
    kf = rng.standard_normal((N, ps, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((N, ps, Hkv, D)).astype(np.float32)
    pages = rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for b in range(B):
        pages[b, -(-int(lens[b]) // ps):] = 0
    case = dict(q=q.to(dtype), table=torch.from_numpy(pages),
                lens=torch.from_numpy(lens))
    if kv is None:
        case["k"] = torch.from_numpy(kf).to(dtype)
        case["v"] = torch.from_numpy(vf).to(dtype)
        return case
    sk = np.exp2(rng.integers(-9, -5, (N, Hkv))).astype(np.float32)
    sv = np.exp2(rng.integers(-9, -5, (N, Hkv))).astype(np.float32)
    if kv == "int8":
        k = torch.from_numpy(np.clip(np.round(kf * 40), -127, 127)).to(torch.int8)
        v = torch.from_numpy(np.clip(np.round(vf * 40), -127, 127)).to(torch.int8)
    else:
        k = torch.from_numpy(np.clip(kf * 60, -440, 440)).to(torch.float8_e4m3fn)
        v = torch.from_numpy(np.clip(vf * 60, -440, 440)).to(torch.float8_e4m3fn)
    case.update(k=k, v=v, k_scale=torch.from_numpy(sk),
                v_scale=torch.from_numpy(sv))
    return case


def run_paged(case, fn, **kw):
    return fn(case["q"], case["k"], case["v"], case["table"], case["lens"],
              k_scale=case.get("k_scale"), v_scale=case.get("v_scale"), **kw)


def merge_by_lse(parts):
    """Merge paged-attention results over disjoint position ranges, each an
    (out (B, Hq, 1, D), lse (B, Hkv, group)) pair, by their log-sum-exps:
    sum_r e^(lse_r - M) out_r / max(sum_r e^(lse_r - M), 1e-30), M the
    largest lse (the tensor-parallel merge of the JAX package's
    ``collectives.tp_paged_decode_attention_merge``).  float32, on the
    parts' device."""
    outs = torch.stack([o[:, :, 0].float() for o, _ in parts])   # (R, B, Hq, D)
    lses = torch.stack([l.reshape(l.shape[0], -1) for _, l in parts])
    m = lses.amax(dim=0)
    w = torch.exp(lses - m)                                      # (R, B, Hq)
    num = (outs * w[..., None]).sum(dim=0)
    den = torch.clamp_min(w.sum(dim=0), 1e-30)
    return (num / den[..., None])[:, :, None]


def assert_within_bf16_ulp(ours: torch.Tensor, ref, ulps=1, atol=0.0):
    """|ours - ref| <= ulps * one bf16 ulp of ref (2^(e-7) for |ref| in
    [2^e, 2^(e+1)); subnormal floor 2^-133) + atol.  The bound is taken in
    float64: a process that loaded XLA may flush float32 subnormals to
    zero."""
    ref = np.asarray(ref, np.float32).astype(np.float64)
    e = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
    bound = ulps * np.maximum(np.exp2(e - 7), 2.0 ** -133) + atol
    diff = np.abs(ours.detach().float().cpu().numpy().astype(np.float64) - ref)
    bad = ~(diff <= bound)
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} outside {ulps} bf16 ulp; worst "
        f"|diff| {diff[bad].max()} at |ref| {np.abs(ref[bad]).max()}")


def rwkv_case(B, H, T, D, seed=0):
    """r, k, v (B, H, T, D) standard normal, decays w in (0.8, 0.999) and
    the bonus u (H, D), float32 numpy (the JAX kernel tests' distributions)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.8, 0.999, (B, H, T, D)).astype(np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32)
    return r, k, v, w, u


def autograd_grads(fn, inputs, douts):
    """``fn``'s outputs on copies of ``inputs`` that require grad, and the
    inputs' gradients for the output gradients ``douts`` (a tensor, or one
    per output with None for an output that gets none)."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    douts = douts if isinstance(douts, tuple) else (douts,)
    pairs = [(o, d) for o, d in zip(outs, douts) if d is not None]
    return outs, torch.autograd.grad([o for o, _ in pairs], xs,
                                     [d for _, d in pairs])


def bf16_ulp_of(x: float) -> float:
    """One bf16 ulp at magnitude |x|: 2^(e-7) for |x| in [2^e, 2^(e+1))."""
    return float(2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7))


def teacher_forced_logits(params, cfg, prompt, tokens, device):
    """The serve path's logits at the positions that chose ``tokens`` after
    ``prompt``, fed prompt + tokens one ``api.decode_step`` at a time from a
    fresh B=1 cache, as the rwkv family's prefill and decode run: (len(tokens),
    V) float32 on the CPU."""
    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int32)
    cache = api.init_cache(cfg, 1, len(seq), device=device)
    out = []
    for t, tok in enumerate(seq):
        logits, cache = api.decode_step(
            params, cache, torch.tensor([int(tok)], dtype=torch.int32,
                                        device=device), cfg)
        if t >= len(prompt) - 1:
            out.append(logits[0].float().cpu())
    return torch.stack(out)


def pick_report(cpu, dev, picks):
    """Logits of the same positions on the CPU and on a device, (n, V), and
    the tokens the device chose there, (n,): the largest |dev - cpu|, the
    largest |cpu|, the largest shortfall max(cpu) - cpu[pick] of a chosen
    token (0 where the CPU would choose it too), and how many of the ``n``
    picks are the CPU's argmax.  A pick the CPU would not make is sound when
    its shortfall is at most twice the logits' gap: a near-tie."""
    cpu, dev = cpu.double(), dev.double()
    picks = torch.as_tensor(np.asarray(picks), dtype=torch.int64)
    chosen = cpu.gather(1, picks[:, None])[:, 0]
    return {"max_abs_err": (dev - cpu).abs().max().item(),
            "max_abs_logit": cpu.abs().max().item(),
            "shortfall": (cpu.max(dim=1).values - chosen).max().item(),
            "argmax_agree": int((cpu.argmax(dim=1) == picks).sum()),
            "n": int(picks.numel())}


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element distance in units in the last place between two float32
    or bfloat16 tensors of one dtype (their bit patterns read as ordered
    integers), int64 on the CPU."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]

    def ordered(t):
        i = t.detach().cpu().contiguous().view(bits).to(torch.int64)
        top = 1 << (8 * t.element_size() - 1)
        return torch.where(i < 0, -(i + top), i)

    return (ordered(a) - ordered(b)).abs()


def rwkv_decay_path_ops(p, x):
    """The element-wise and matmul ops of one rwkv6 time-mix on the way to
    the decay and the gate, in ``models/rwkv6.py``'s order: a list of
    ``(name, fn, input names)`` whose fns take and return tensors, starting
    from the pre-normed input ``x`` (B, T, d)."""
    from repro_torch.models import layers as L
    from repro_torch.models.rwkv6 import _token_shift, decay
    f32 = torch.float32
    mix = p["mix"].to(x.dtype)
    return [
        ("lerp_w", lambda x: x + mix[4] * (_token_shift(x) - x), ["x"]),
        ("lerp_g", lambda x: x + mix[3] * (_token_shift(x) - x), ["x"]),
        ("linear_lora_a", lambda a: L.linear(a, p["w_lora_a"]), ["lerp_w"]),
        ("tanh", torch.tanh, ["linear_lora_a"]),
        ("linear_lora_b", lambda a: L.linear(a, p["w_lora_b"]), ["tanh"]),
        ("w0_plus_dw", lambda a: p["w0"].to(f32) + a.to(f32),
         ["linear_lora_b"]),
        ("exp_inner", torch.exp, ["w0_plus_dw"]),
        ("exp_outer", lambda a: torch.exp(-a), ["exp_inner"]),
        ("decay_bf16", lambda a: a.to(x.dtype), ["exp_outer"]),
        ("decay", lambda a: decay(p["w0"], a).to(x.dtype),
         ["linear_lora_b"]),
        ("linear_wg", lambda a: L.linear(a, p["wg"]), ["lerp_g"]),
        ("silu", L.silu, ["linear_wg"]),
    ]


def rwkv_decay_bits_report(p, x, device):
    """Each op of :func:`rwkv_decay_path_ops` run on the CPU and on
    ``device`` from the same CPU inputs (the CPU's outputs of the ops before
    it): ``{name: {"differ": elements whose bits differ, "n": elements,
    "max_ulps": largest ulp distance}}``."""
    vals = {"x": x.cpu()}
    report = {}
    for name, fn, ins in rwkv_decay_path_ops(
            {k: v.cpu() for k, v in p.items()}, x.cpu()):
        vals[name] = fn(*[vals[i] for i in ins])
    for name, fn, ins in rwkv_decay_path_ops(
            {k: v.to(device) for k, v in p.items()}, x.to(device)):
        out = fn(*[vals[i].to(device) for i in ins])
        d = ulp_distance(out, vals[name])
        report[name] = {"differ": int((d > 0).sum()), "n": d.numel(),
                        "max_ulps": int(d.max())}
    return report


def feature_prompts(vocab, seed=0, page=8):
    """Prompts that exercise shared-prefix reuse on a pool of ``page``-token
    pages: a two-page prefix P; P plus tails of 5, 9, 3 and 1 tokens (the
    first publishes P, the next three hit it partially, the 1-token tail is a
    whole-body hit); P itself (a whole-body hit whose last matched page holds
    the decode append position: a copy-on-write copy); P's first 12 tokens
    (a partial hit of one page, usable only with chunked prefill); and one
    unrelated prompt of 7 tokens.  int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(1, vocab, 2 * page).astype(np.int32)
    out = [np.concatenate([pre, rng.integers(1, vocab, t).astype(np.int32)])
           for t in (5, 9, 3, 1)]
    out += [pre.copy(), pre[:12].copy(),
            rng.integers(1, vocab, 7).astype(np.int32)]
    return out


def serve_staged(scheds, request_lists, each=None, max_iters=400):
    """Serve one request list per scheduler, all in lockstep: each list's
    first request is submitted alone and stepped until it decodes on every
    scheduler (so its prefix pages are published first), then the rest are
    submitted.  ``each(iteration)`` runs after every step.  Returns each
    scheduler's results sorted by uid."""
    for s, reqs in zip(scheds, request_lists):
        s.begin()
        assert s.submit(reqs[0])
    it = 0
    while not all(request_lists[i][0].uid in s.decoding_uids()
                  for i, s in enumerate(scheds)):
        for s in scheds:
            s.step()
        it += 1
        if each is not None:
            each(it)
        assert it < max_iters
    for s, reqs in zip(scheds, request_lists):
        for r in reqs[1:]:
            assert s.submit(r)
    while any(s.has_work() for s in scheds):
        for s in scheds:
            s.step()
        it += 1
        if each is not None:
            each(it)
        assert it < max_iters
    return [sorted(s.poll(), key=lambda r: r.uid) for s in scheds]


def record_prefills(eng):
    """Make ``eng.prefill_slot`` also keep each (prompt, request cache moved
    to the CPU, first decode token) it returns, in call order; returns that
    list."""
    kept, fn = [], eng.prefill_slot

    def prefill_slot(prompt):
        cache, tok = fn(prompt)
        kept.append((np.asarray(prompt).tolist(), {
            k: [t.cpu() for t in v] if isinstance(v, list) else v.cpu()
            for k, v in cache.items()}, tok))
        return cache, tok

    eng.prefill_slot = prefill_slot
    return kept


def replay_prefills(eng, kept):
    """Make ``eng.prefill_slot`` hand back :func:`record_prefills`' request
    caches, in order, for the same prompts: another device then decodes
    from the recording device's prefill."""
    it = iter(kept)

    def prefill_slot(prompt):
        want, cache, tok = next(it)
        assert np.asarray(prompt).tolist() == want, "prompts out of order"
        dev = eng.device
        return {k: [t.to(dev) for t in v] if isinstance(v, list)
                else v.to(dev) for k, v in cache.items()}, tok

    eng.prefill_slot = prefill_slot
