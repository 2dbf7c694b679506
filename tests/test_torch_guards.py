"""Guards of the port's contract: no JAX and nothing of the JAX package in
``repro_torch``, no silent run on the CPU, and no CUDA wrapper that falls
back to the plain version."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import device
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import paged_attention as kpa
from repro_torch.kernels import rwkv_scan as krw
from repro_torch.kernels import w4a8_matmul as kw
from repro_torch.models import api
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.splitbrain_engine import SplitBrainEngine
from torch_cases import paged_case, run_paged, rwkv_case, w4a8_case

PKG = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)")


def test_static_scan_finds_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 20
    examples = sorted((PKG.parent.parent / "examples").glob("*_torch.py"))
    assert len(examples) == 3
    files += examples
    bad = [f"{f.name}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if FORBIDDEN.match(line)]
    assert not bad, bad


# the jax-free modules the port copies, the hymba family, the MoE FFN,
# the encoder-decoder family with their configs, the tensor-parallel
# package, the training path (data, optimizer, train step, checkpoints,
# the training CLI), distributed training (the grids, the pipeline) and
# the paper's cost and FPGA models, and the dry run (the kernels' work
# formulas, the meta-device tally, the CLI, its reanalysis and report):
# they must be among the modules the scan imports
NEW_MODULES = ("repro_torch.distributed.runtime",
               "repro_torch.distributed.sharding",
               "repro_torch.distributed.collectives",
               "repro_torch.serve.faults", "repro_torch.serve.server",
               "repro_torch.serve.disciplines", "repro_torch.models.hymba",
               "repro_torch.configs.hymba_1_5b", "repro_torch.models.moe",
               "repro_torch.configs.phi3_5_moe_42b_a6_6b",
               "repro_torch.configs.qwen3_moe_235b_a22b",
               "repro_torch.models.encdec",
               "repro_torch.configs.seamless_m4t_medium",
               "repro_torch.configs.llama_3_2_vision_11b",
               "repro_torch.data.pipeline", "repro_torch.train.optimizer",
               "repro_torch.train.step", "repro_torch.ckpt.manager",
               "repro_torch.launch.train", "repro_torch.launch.mesh",
               "repro_torch.distributed.pipeline",
               "repro_torch.core.costmodel", "repro_torch.core.fpga",
               "repro_torch.kernels.costs", "repro_torch.launch.op_analysis",
               "repro_torch.launch.dryrun", "repro_torch.launch.reanalyze",
               "repro_torch.launch.report")
# the port's examples, loaded by path in the same process as the modules
EXAMPLES = ("quickstart_torch", "serve_splitbrain_torch", "train_e2e_torch")


def test_importing_every_module_loads_no_jax_or_repro():
    examples = PKG.parent.parent / "examples"
    script = (
        "import importlib, importlib.util, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"for name in {EXAMPLES!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        f"        name, {str(examples)!r} + '/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        f"missing = sorted(set({NEW_MODULES!r}) - set(sys.modules))\n"
        "print(len(mods), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(mods) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_engine_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tinyllama-1.1b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SplitBrainEngine(cfg, params, page_size=8, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SplitBrainEngine(cfg, params, page_size=8, max_len=32, device="cuda")
    SplitBrainEngine(cfg, params, page_size=8, max_len=32, device="cpu")


def test_serve_engine_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama2-7b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for kw in (dict(), dict(device="cuda"), dict(page_size=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params, max_len=32, **kw)
    ServeEngine(cfg, params, max_len=32, page_size=8, device="cpu")


def test_exact_matmuls_turns_reduced_precision_off_and_reads_it_back():
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    try:
        m.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        m.allow_bf16_reduced_precision_reduction = True
        assert device.exact_matmuls() == {
            "allow_tf32": False, "cudnn_allow_tf32": False,
            "allow_bf16_reduced_precision_reduction": False}
        assert device.matmul_settings() == device.exact_matmuls()
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = saved


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """Pretend every tensor lies on the card while no kernel library exists
    and none can be built; make the plain versions fail loudly if used."""
    monkeypatch.setattr(build, "is_cuda", lambda t: True)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(ref, "w4a8_matmul", plain)
    monkeypatch.setattr(ref, "paged_decode_attention", plain)
    monkeypatch.setattr(ref, "flash_attention", plain)
    monkeypatch.setattr(ref, "rwkv6_scan", plain)


def _flash_case(dtype=torch.bfloat16, D=16):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            for s in ((1, 4, 5, D), (1, 2, 5, D), (1, 2, 5, D))]


def test_cuda_wrappers_raise_instead_of_falling_back(no_library):
    ops.reset_launch_counts()
    ts = [torch.from_numpy(a) for a in w4a8_case(2, 64, 32)]
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.w4a8_matmul(*ts, packed=kw.pack_codes(ts[2]))
    with pytest.raises(RuntimeError, match="nvcc"):
        run_paged(paged_case(0), ops.paged_decode_attention)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.attention(*_flash_case(), causal=True)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.rwkv6(*(torch.from_numpy(a) for a in rwkv_case(1, 2, 5, 16)))
    assert ops.launch_counts() == {"w4a8_matmul": 0,
                                   "paged_decode_attention": 0,
                                   "flash_attention": 0, "rwkv6_scan": 0}


def test_cuda_wrappers_check_operands(no_library):
    qx, xs, codes, ws = [torch.from_numpy(a) for a in w4a8_case(2, 64, 32)]
    with pytest.raises(ValueError, match="int8"):
        kw.w4a8_matmul(qx.float(), xs, codes, ws)
    with pytest.raises(ValueError, match="contiguous"):
        kw.w4a8_matmul(qx, xs, codes.t().contiguous().t(), ws)
    with pytest.raises(ValueError, match="contraction"):
        kw.w4a8_matmul(qx[:, :32].contiguous(), xs, codes, ws)
    # the kernel reads the packed codes, made once with the weights: a call
    # without them, or with another matrix's, raises (it never packs)
    n0 = kw.pack_codes.calls
    with pytest.raises(ValueError, match="packed codes"):
        ops.w4a8_matmul(qx, xs, codes, ws)
    assert kw.pack_codes.calls == n0
    with pytest.raises(ValueError, match="packed must be uint8"):
        kw.w4a8_matmul(qx, xs, codes, ws,
                       packed=kw.pack_codes(codes[:, :16].contiguous()))
    case = paged_case(0)
    with pytest.raises(ValueError, match="int32"):
        kpa.paged_decode_attention(case["q"], case["k"], case["v"],
                                   case["table"].long(), case["lens"])
    with pytest.raises(ValueError, match="together"):
        kpa.paged_decode_attention(case["q"], case["k"], case["v"],
                                   case["table"], case["lens"],
                                   k_scale=torch.ones(13, 2))
    case = paged_case(0, D=48)
    with pytest.raises(ValueError, match="head dim 48"):
        kpa.paged_decode_attention(case["q"], case["k"], case["v"],
                                   case["table"], case["lens"])
    q, k, v = _flash_case()
    with pytest.raises(ValueError, match="kv_offset"):
        kfa.flash_attention(q, k, v, kv_offset=-1)
    with pytest.raises(ValueError, match="dtypes differ"):
        kfa.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="multiple of 16"):
        kfa.flash_attention(*_flash_case(D=24))
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v)
    with pytest.raises(ValueError, match="multiple of"):
        kfa.flash_attention(q[:, :3].contiguous(), k, v)
    r, k, v, w, u = (torch.from_numpy(a) for a in rwkv_case(1, 2, 5, 16))
    with pytest.raises(ValueError, match="head dim"):
        krw.rwkv6_scan(*(torch.from_numpy(a) for a in rwkv_case(1, 2, 5, 8)))
    with pytest.raises(ValueError, match="does not match"):
        krw.rwkv6_scan(r, k.to(torch.bfloat16), v, w, u)
    with pytest.raises(ValueError, match="u must be float32"):
        krw.rwkv6_scan(r, k, v, w, u.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        krw.rwkv6_scan(r.transpose(2, 3), k, v, w, u)
    with pytest.raises(ValueError, match="empty"):
        krw.rwkv6_scan(*(t[:, :, :0] for t in (r, k, v, w)), u)


def test_rwkv_with_a_carried_state_takes_the_plain_version(monkeypatch):
    """The JAX package's own dispatch: its scan kernel starts from a zero
    state only, so a call that carries one (each decode step) is plain on
    every device -- and builds nothing."""
    monkeypatch.setattr(build, "is_cuda", lambda t: True)
    monkeypatch.setattr(build, "find_nvcc", lambda: 1 / 0)
    r, k, v, w, u = (torch.from_numpy(a) for a in rwkv_case(1, 2, 5, 16))
    state = torch.ones((1, 2, 16, 16))
    n0 = krw.rwkv6_scan.launches
    out, s = ops.rwkv6(r, k, v, w, u, state)
    want = ref.rwkv6_scan(r, k, v, w, u, state)
    assert torch.equal(out, want[0]) and torch.equal(s, want[1])
    assert krw.rwkv6_scan.launches == n0


@pytest.mark.parametrize("M,K,N", [(1, 2048, 2048), (8, 2048, 256),
                                   (8, 5632, 2048), (3, 2048, 32000),
                                   (13, 100, 37), (8, 11008, 4096),
                                   (8, 2048, 5632), (1, 4096, 4096),
                                   (8, 4096, 11008), (8, 4096, 32000),
                                   (5, 65536, 40), (1, 1, 1)])
def test_w4a8_launch_shape_covers_k(M, K, N):
    """The launch plan (from shapes only) gives every (n tile, k tile) to
    exactly one warp, in balanced K ranges, and every activation row to one
    block, within the card's limits."""
    plan = kw.launch_plan(M, N, K, sm_count=132)
    n_tiles, k_tiles = kw.packed_shape(K, N)[:2]
    assert plan.wn * plan.wk == 8 and plan.wk in (1, 2, 4, 8)
    assert 1 <= plan.ck <= kw.MAX_CLUSTER and plan.grid[1] == plan.ck
    assert (plan.grid[0] - 1) * plan.wn < n_tiles <= plan.grid[0] * plan.wn
    assert (plan.grid[2] - 1) * 8 < M <= plan.grid[2] * 8
    # each warp's K range in k tiles, in split order (rank * wk + the
    # warp's K index), as csrc/w4a8_matmul.cu::split_begin computes them
    splits = plan.wk * plan.ck
    ranges = [(i * k_tiles // splits, (i + 1) * k_tiles // splits)
              for i in range(splits)]
    assert len(ranges) == plan.wk * plan.ck
    assert ranges[0][0] == 0 and ranges[-1][1] == k_tiles
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(b - a <= -(-k_tiles // len(ranges)) for a, b in ranges)
    assert plan.grid[0] * plan.ck >= min(132, n_tiles * plan.ck // plan.wn)


def test_w4a8_launch_plan_refuses_k_the_int32_sum_cannot_hold():
    with pytest.raises(ValueError, match="K 65537"):
        kw.launch_plan(1, 16, 65537, sm_count=132)


def test_build_targets_sm90a_without_fast_math():
    assert [p.name for p in build.sources()] == ["flash_attention.cu",
                                                 "paged_attention.cu",
                                                 "rwkv_scan.cu",
                                                 "w4a8_matmul.cu"]
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "-O3" in flags
    assert build.BUILD_DIR.name == "build"     # listed in .gitignore
    assert np.all([("csrc" in str(p)) for p in build.sources()])
