"""Seeded numpy inputs, tolerances and the teacher-forced card-vs-CPU logit
check shared by the ``test_torch_*`` files and ``chip_smoke.py``.

Imports neither JAX nor the JAX package, so the ``gpu`` tests that use it
also run on a machine with only PyTorch.
"""
import numpy as np
import torch

from repro_torch.models import api


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
