"""The W4A8 kernel's own weight layout and launch plan, on the CPU.

``kernels/w4a8_matmul.py::pack_codes`` stores INT4 codes two per byte in the
order the CUDA kernel's MMA fragments read them.  The kernel cannot run
here, so :func:`emulate_kernel` replays ``csrc/w4a8_matmul.cu`` step by
step in numpy -- each warp's K range, the activation bytes each lane
reads, the nibble-to-byte moves, ``mma.sync.m16n8k32.row.col.s32.s8.s8`` with the PTX
ISA's fragment layouts, the partials' reduction inside a block and across
a cluster, the scale epilogue -- and is held bit for bit to the plain
version.  The card tests (``test_torch_gpu.py``) hold the kernel itself to
the plain version.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.kernels import ref
from repro_torch.kernels import w4a8_matmul as kw
from repro_torch.models import api
from repro_torch.serve import splitbrain_engine as sbe
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from torch_cases import w4a8_case

MASK = np.uint32(0xF0F0F0F0)


def _codes(shape, seed):
    """Random codes over the 15 values of [-7, 7], each present where the
    shape holds 15 or more."""
    c = np.random.default_rng(seed).integers(-7, 8, shape).astype(np.int8)
    flat = c.reshape(-1)
    flat[:15] = np.arange(-7, 8)[:flat.size]
    return torch.from_numpy(c)


@pytest.mark.parametrize("K,N", [(64, 16), (100, 37), (2048, 256), (130, 5),
                                 (1, 1), (65, 17)])
def test_pack_unpack_round_trip(K, N):
    codes = _codes((K, N), seed=K + N)
    packed = kw.pack_codes(codes)
    assert packed.dtype == torch.uint8
    assert tuple(packed.shape) == kw.packed_shape(K, N)
    assert packed.numel() == -(-K // 64) * 64 * -(-N // 16) * 16 // 2
    assert torch.equal(kw.unpack_codes(packed, K, N), codes)
    # the padding holds zero codes: the padded matrix unpacks with zeros
    nt, kt = kw.packed_shape(K, N)[:2]
    full = kw.unpack_codes(packed, kt * 64, nt * 16)
    assert torch.equal(full[:K, :N], codes)
    assert not full[K:].any() and not full[:, N:].any()


def test_pack_refuses_what_a_nibble_cannot_hold():
    with pytest.raises(ValueError, match="INT4"):
        kw.pack_codes(torch.full((4, 4), 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        kw.pack_codes(torch.zeros((4, 4), dtype=torch.int16))
    assert torch.equal(kw.unpack_codes(kw.pack_codes(
        torch.full((3, 2), -8, dtype=torch.int8)), 3, 2),
        torch.full((3, 2), -8, dtype=torch.int8))


def test_stacked_codes_pack_per_layer_through_getitem():
    L, K, N = 3, 150, 40
    ql = quant.QuantizedLinear(_codes((L, K, N), seed=1),
                               torch.rand((L, N))).with_packed()
    assert tuple(ql.packed.shape) == (L,) + kw.packed_shape(K, N)
    for i in range(L):
        layer = ql[i]
        assert torch.equal(layer.packed, kw.pack_codes(layer.codes))
        assert torch.equal(kw.unpack_codes(layer.packed, K, N), layer.codes)
    assert ql.with_packed() is ql             # packs only what lacks it


@pytest.mark.parametrize("M,K,N", [(1, 2048, 256), (8, 100, 37), (13, 257, 130)])
def test_plain_product_on_unpacked_codes_equals_codes(M, K, N):
    qx, xs, codes, ws = (torch.from_numpy(a) for a in w4a8_case(M, K, N, seed=M))
    back = kw.unpack_codes(kw.pack_codes(codes), K, N)
    for dt in (torch.bfloat16, torch.float32):
        assert torch.equal(ref.w4a8_matmul(qx, xs, back, ws, dt),
                           ref.w4a8_matmul(qx, xs, codes, ws, dt))


# --------------------------------------------------------------- emulation
def _mma_m16n8k32(a_regs, b_regs):
    """mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 over one warp: the
    PTX ISA's fragment layouts (groupID g = lane >> 2, t = lane % 4).
    A (16 x 32): element i of a lane's 16 bytes sits at row g (+8 for
    i in 4..7 and 12..15), column 4t + i % 4 (+16 for i >= 8).  B (32 x 8):
    element i of its 8 bytes at row 4t + i % 4 (+16 for i >= 4), column g.
    C (16 x 8): c_i at row g (+8 for i >= 2), column 2t + i % 2.
    a_regs (32, 4), b_regs (32, 2) uint32 -> (32, 4) int64."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    a = a_regs.astype("<u4").view(np.int8).reshape(32, 16).astype(np.int64)
    b = b_regs.astype("<u4").view(np.int8).reshape(32, 8).astype(np.int64)
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for i in range(16):
        A[g + 8 * ((i // 4) % 2), 4 * t + i % 4 + 16 * (i >= 8)] = a[:, i]
    for i in range(8):
        B[4 * t + i % 4 + 16 * (i >= 4), g] = b[:, i]
    C = A @ B
    return np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                     C[g + 8, 2 * t + 1]], axis=1)


def emulate_kernel(qx, x_scale, packed, w_scale, N, plan, out_dtype):
    """What csrc/w4a8_matmul.cu computes, block by block, in numpy."""
    M, K = qx.shape
    n_tiles, k_tiles = kw.packed_shape(K, N)[:2]
    wn, wk, ck = plan.wn, plan.wk, plan.ck
    splits, ldr = wk * ck, wn * 16
    words = np.ascontiguousarray(packed).view("<u4").reshape(
        n_tiles, k_tiles, 32, 4)
    qpad = np.zeros((M, k_tiles * 64 + 64), np.int8)
    qpad[:, :K] = qx
    out = np.zeros((M, N), np.float32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for bz in range(plan.grid[2]):
        m0 = bz * 8
        rows = np.zeros((8, qpad.shape[1]), np.int8)
        rows[:min(8, M - m0)] = qpad[m0:m0 + 8]
        for bx in range(plan.grid[0]):
            reds = []
            for rank in range(ck):
                red = np.zeros((wk, 8, ldr), np.int64)
                for warp in range(8):
                    w_n, w_k = warp % wn, warp // wn
                    n_tile = bx * wn + w_n
                    kt0 = (rank * wk + w_k) * k_tiles // splits
                    kt1 = (rank * wk + w_k + 1) * k_tiles // splits
                    acc = np.zeros((32, 4), np.int64)
                    for kt in range(kt0, kt1) if n_tile < n_tiles else ():
                        p = words[n_tile, kt]                   # (32, 4)
                        # the lane's B words: qx[g, 64 kt + 16t + 4j .. +3]
                        k = 64 * kt + 16 * t[:, None] + 4 * np.arange(4)[None, :]
                        xb = np.stack([rows[g[:, None], k + b] for b in range(4)],
                                      axis=-1).copy().view("<u4")[..., 0]
                        lo, hi = (p << np.uint32(4)) & MASK, p & MASK
                        for s in range(2):
                            a_regs = np.stack([lo[:, 2 * s], hi[:, 2 * s],
                                               lo[:, 2 * s + 1], hi[:, 2 * s + 1]], 1)
                            acc += _mma_m16n8k32(a_regs, xb[:, 2 * s:2 * s + 2])
                    red[w_k, 2 * t, w_n * 16 + g] = acc[:, 0]
                    red[w_k, 2 * t + 1, w_n * 16 + g] = acc[:, 1]
                    red[w_k, 2 * t, w_n * 16 + g + 8] = acc[:, 2]
                    red[w_k, 2 * t + 1, w_n * 16 + g + 8] = acc[:, 3]
                reds.append(red.sum(axis=0))
            total = np.sum(reds, axis=0)                      # (8, ldr)
            assert np.all(np.abs(total) < 2 ** 31) and not np.any(total % 16)
            for m in range(8):
                for nl in range(ldr):
                    mm, n = m0 + m, bx * ldr + nl
                    if mm < M and n < N:
                        v = np.float32(total[m, nl] >> 4)
                        out[mm, n] = (v * x_scale[mm, 0]) * w_scale[n]
    return torch.from_numpy(out).to(out_dtype)


@pytest.mark.parametrize("M,K,N,sm", [(1, 256, 64, 132), (8, 512, 48, 4),
                                      (3, 100, 37, 132), (13, 640, 130, 2),
                                      (5, 1000, 33, 1), (2, 4160, 16, 132)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_emulated_kernel_equals_plain(M, K, N, sm, out_dtype):
    """The kernel's data flow on the packed layout, at plans with and
    without a cluster split, in-block K splits, several n tiles per block
    and ragged M, K and N: bit-identical to the plain version."""
    qx, xs, codes, ws = w4a8_case(M, K, N, seed=K)
    plan = kw.launch_plan(M, N, K, sm)
    packed = kw.pack_codes(torch.from_numpy(codes)).numpy()
    got = emulate_kernel(qx, xs, packed, ws, N, plan, out_dtype)
    want = ref.w4a8_matmul(*(torch.from_numpy(a) for a in (qx, xs, codes, ws)),
                           out_dtype)
    assert torch.equal(got, want)


def test_emulated_plans_cover_clusters_and_in_block_splits():
    """The emulated cases above reach every part of the kernel's plan."""
    plans = [kw.launch_plan(M, N, K, sm) for M, K, N, sm in
             [(1, 256, 64, 132), (8, 512, 48, 4), (3, 100, 37, 132),
              (13, 640, 130, 2), (5, 1000, 33, 1), (2, 4160, 16, 132)]]
    assert any(p.ck > 1 for p in plans) and any(p.wk > 1 for p in plans)
    assert any(p.wn > 1 for p in plans) and any(p.grid[2] > 1 for p in plans)


# ------------------------------------------------------------- the engine
def test_engine_packs_once_at_construction_and_steps_pack_nothing():
    cfg = get_config("tinyllama-1.1b").reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n0 = kw.pack_codes.calls
    eng = sbe.SplitBrainEngine(cfg, params, max_len=32, page_size=8,
                               device="cpu")
    built = kw.pack_codes.calls - n0
    assert built == 8            # 7 stacked projections + the LM head
    for layer in eng._layers:
        for w in (*layer["attn"].values(), *layer["mlp"].values()):
            assert torch.equal(w.packed, kw.pack_codes(w.codes))
    assert torch.equal(eng._head.packed, kw.pack_codes(eng._head.codes))
    n1 = kw.pack_codes.calls
    reqs = [Request(uid=i, prompt=np.arange(1, 6 + 2 * i, dtype=np.int32),
                    max_new=4) for i in range(3)]
    out = ContinuousBatchingScheduler(eng, max_slots=2).run(reqs)
    assert out["steps"] > 0 and kw.pack_codes.calls == n1


def test_rebuilding_a_quantized_layer_keeps_its_packed_codes():
    ql = quant.QuantizedLinear(_codes((2, 3, 64, 16), seed=2),
                               torch.rand((2, 3, 16))).with_packed()
    for moved in (sbe._to({"w": ql}, "cpu")["w"], ql.to("cpu")):
        assert torch.equal(moved.packed, ql.packed)
    stacked = sbe._stack_layers({"w": ql}, 6)["w"]
    assert tuple(stacked.packed.shape) == (6,) + kw.packed_shape(64, 16)
    assert torch.equal(stacked[4].packed, ql[1, 1].packed)
    assert api.pack_model({"w": stacked})["w"].packed is stacked.packed
    back = api.params_from_numpy({"w": ql}, "cpu")["w"]
    assert torch.equal(back.packed, ql.packed)
