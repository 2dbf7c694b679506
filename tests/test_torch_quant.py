"""repro_torch LAQ quantizer and W4A8 matmul against the JAX package.

Integer paths carry no tolerance: LAQ codes and scales, int8 activation
codes and scales, and W4A8 outputs (exact int32 accumulation, one bf16
rounding) must be bit-identical.  The W4A8 CUDA kernel is held to its plain
version on the card in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp

from repro.configs import get_config
from repro.core import quant as jq
from repro.kernels import ref as jref
from repro.kernels import w4a8_matmul as jw4a8
from repro.models import api as japi
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import quant as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import api as tapi
from torch_cases import w4a8_case


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if jnp.asarray(a).dtype == jnp.bfloat16 else np.asarray(a)


def _t2np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("logic_aware", [True, False])
@pytest.mark.parametrize("shape,scale", [((64, 128), 0.05), ((300, 37), 1.0)])
def test_laq_codes_and_scales_bit_identical(logic_aware, shape, scale):
    w = (np.random.default_rng(0).standard_normal(shape) * scale).astype(np.float32)
    w[:, 3] = 0.0                      # an all-zero column hits the 1e-12 floor
    a = jq.quantize_weights(jnp.asarray(w), logic_aware=logic_aware)
    b = tq.quantize_weights(torch.from_numpy(w), logic_aware=logic_aware)
    np.testing.assert_array_equal(np.asarray(a.codes), b.codes.numpy())
    np.testing.assert_array_equal(np.asarray(a.scales), b.scales.numpy())
    assert b.codes.dtype == torch.int8 and int(b.codes.abs().max()) <= 7


@pytest.mark.parametrize("per_tensor", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_codes_bit_identical(per_tensor, dtype):
    x = np.random.default_rng(1).standard_normal((7, 96)).astype(np.float32)
    x[2] = 0.0                         # a zero row hits the 1e-12 floor
    x[4, :3] = [0.5, -0.5, 2.5]        # exact halves: round half to even
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qa, sa = jax.jit(lambda v: jq.quantize_activations_int8(
        v, per_tensor=per_tensor))(xj)
    qb, sb = tq.quantize_activations_int8(xt, per_tensor=per_tensor)
    np.testing.assert_array_equal(np.asarray(qa), qb.numpy())
    np.testing.assert_array_equal(np.asarray(sa), sb.numpy())


def test_quantize_model_matches_leaf_by_leaf():
    cfg = get_config("tinyllama-1.1b").reduced()
    tcfg = t_get_config("tinyllama-1.1b").reduced()
    params = japi.init_params(cfg, jax.random.PRNGKey(0))
    qj = jax.tree.map(np.asarray, japi.quantize_model(params, cfg))
    qt = tapi.quantize_model(
        tapi.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"), tcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(qj)[0]
    assert len(flat_j) == 20           # 8 quantized weights x 2 + 4 float leaves
    for path, leaf in flat_j:
        node = qt
        for key in path:
            node = (getattr(node, key.name) if hasattr(key, "name")
                    else node[key.key])
        np.testing.assert_array_equal(leaf, node.numpy(), err_msg=str(path))
    # the bridge recognises quantized leaves by attribute and keeps them whole
    back = tapi.params_from_numpy(qj, "cpu")
    assert isinstance(back["lm_head"], tq.QuantizedLinear)
    np.testing.assert_array_equal(back["lm_head"].codes.numpy(),
                                  qj["lm_head"].codes)


@pytest.mark.parametrize("M,K,N", [(8, 512, 256), (16, 1024, 512), (1, 256, 128)])
def test_w4a8_plain_equals_pallas_and_oracle(M, K, N):
    """Shapes the Pallas tiles divide: plain == Pallas (interpret) == oracle,
    bit for bit in bf16."""
    qx, xs, codes, ws = w4a8_case(M, K, N)
    args = [jnp.asarray(a) for a in (qx, xs, codes, ws)]
    pallas = jw4a8.w4a8_matmul(*args, bm=min(M, 8), bn=128, bk=256,
                               interpret=True)
    oracle = jref.w4a8_matmul(*args)
    ours = tref.w4a8_matmul(*[torch.from_numpy(a) for a in (qx, xs, codes, ws)])
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(pallas), _t2np(ours))
    np.testing.assert_array_equal(_np(oracle), _t2np(ours))


def test_w4a8_plain_equals_oracle_ragged_and_dispatch():
    """A ragged shape (no tile divides it) against the JAX oracle; the
    dispatcher sends CPU tensors to the plain version."""
    qx, xs, codes, ws = w4a8_case(3, 100, 37, seed=2)
    oracle = jref.w4a8_matmul(*[jnp.asarray(a) for a in (qx, xs, codes, ws)])
    ts = [torch.from_numpy(a) for a in (qx, xs, codes, ws)]
    np.testing.assert_array_equal(_np(oracle), _t2np(tref.w4a8_matmul(*ts)))
    np.testing.assert_array_equal(_np(oracle), _t2np(tops.w4a8_matmul(*ts)))
    # the int32 accumulator itself, at tinyllama's largest K
    qx, _, codes, _ = w4a8_case(2, 5632, 16, seed=3)
    acc = tq.int_matmul(torch.from_numpy(qx), torch.from_numpy(codes))
    np.testing.assert_array_equal(
        qx.astype(np.int64) @ codes.astype(np.int64), acc.numpy())


def test_dequantize_and_w4a8_matmul_ref_bit_identical():
    """The functional W4A8 model (activation quantization, int32 sums,
    rescale) and the dequantizer against the JAX package's."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((96, 40)) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 3, 96)).astype(np.float32)
    qj = jq.quantize_weights(jnp.asarray(w))
    qt = tq.quantize_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(_np(jq.dequantize(qj)),
                                  _t2np(tq.dequantize(qt)))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(_np(jax.jit(jq.w4a8_matmul_ref)(xj, qj)),
                                  _t2np(tq.w4a8_matmul_ref(xt, qt)))
