"""The port's int8-compressed data-parallel reduction, its GPipe pipeline
and Megatron's autograd collectives, on four gloo ranks on the CPU (one
spawn of a (2, 2) grid), against the JAX package's
``distributed/{collectives,pipeline}.py`` run in one subprocess with four
forced host devices (Auto-axis meshes), started before the ranks.

Bounds, each with the value measured when it was set:

* ``compressed_psum_mean`` over 4 ranks (leaves of 300, 7 and 3,072
  floats: the first two pad their last block): bit-identical to the
  jitted JAX one on the same numpy inputs (measured: identical), and
  within the reference test's ``2 max|x| / 127`` of the exact mean.
* ``dp_train_step_compressed`` at dp 2 (granite-8b reduced, float32
  compute, the JAX package's params, 2 rows a rank): the loss within a
  relative 1e-6 of the JAX one (measured 8.4e-8), each gradient leaf
  within ``2 max|g| / 127`` of the JAX one, the int8 wire's two
  quantization steps (measured at most 0.34 of that bound: a code that
  flips on a last-bit difference of the local gradients moves one step).
* ``pipeline_apply`` at 4 stages and 8 microbatches (width 32, ``tanh(x @
  W_s)`` float32): bit-identical to the sequential application in one
  process, every rank the same, and within 1e-5 of the JAX one (measured
  3.0e-7); ``bubble_fraction`` equal to the reference's.
* Megatron's collectives against the same computation unsharded, in
  float64: values and every gradient within 1e-12 (measured 1.1e-14).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro_torch.distributed import pipeline as tpipe
from repro_torch.distributed import runtime
from torch_dist_cases import (ARCH, BLOCK, PIPE, collectives_grid_rank,
                              numpy_batch, pipe_inputs, psum_inputs)
from torch_train_cases import configs, numpy_params

_JAX = """
    import dataclasses, pickle
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed.collectives import (compressed_psum_mean,
                                               dp_train_step_compressed)
    from repro.distributed.pipeline import bubble_fraction, pipeline_apply
    from repro.models import api

    with open({path!r}, "rb") as f:
        inp = pickle.load(f)
    devs = jax.devices()
    auto = (AxisType.Auto,)
    out = {{}}
    mesh4 = jax.make_mesh((4,), ("data",), axis_types=auto, devices=devs)
    stacked = jax.tree.map(lambda *a: np.stack(a), *inp["psum"])
    f = shard_map(lambda t: compressed_psum_mean(
        jax.tree.map(lambda a: a[0], t), "data", {block}), mesh=mesh4,
        in_specs=P("data"), out_specs=P(), check_rep=False)
    out["psum"] = jax.tree.map(np.asarray, jax.jit(f)(stacked))
    meshp = jax.make_mesh((4,), ("pipe",), axis_types=auto, devices=devs)
    apply = pipeline_apply(meshp, lambda w, x: jnp.tanh(x @ w), {m})
    out["piped"] = np.asarray(jax.jit(apply)(inp["ws"], inp["x"]))
    out["bubble"] = [bubble_fraction(s, m) for s in (1, 2, 4, 8)
                     for m in (1, 4, 8, 16)]
    mesh2 = jax.make_mesh((2,), ("data",), axis_types=auto,
                          devices=devs[:2])
    cfg = dataclasses.replace(get_config({arch!r}).reduced(),
                              dtype="float32", use_pallas=False)
    fn = dp_train_step_compressed(lambda p, b: api.loss_fn(p, b, cfg)[0],
                                  mesh2, "data", {block})
    loss, grads = jax.jit(fn)(inp["params"], inp["batch"])
    out["dp_loss"] = float(loss)
    out["dp_grads"] = jax.tree.map(np.asarray, grads)
    with open({path!r} + ".out", "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The JAX subprocess (started first) and the port's (2, 2) spawn."""
    cfg, _ = configs(ARCH, dtype="float32")
    params = numpy_params(cfg)
    batch = numpy_batch(cfg.vocab_size)
    ws, x = pipe_inputs()
    path = str(tmp_path_factory.mktemp("dist_coll") / "in.pkl")
    with open(path, "wb") as f:
        pickle.dump({"psum": psum_inputs(4), "ws": ws, "x": x,
                     "params": params, "batch": batch}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""))
    script = textwrap.dedent(_JAX.format(path=path, block=BLOCK, arch=ARCH,
                                         m=PIPE["microbatches"]))
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ranks = runtime.spawn(collectives_grid_rank, (2, 2), (params, batch),
                              backend="gloo", devices=["cpu"] * 4,
                              timeout=600)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out + err
    with open(path + ".out", "rb") as f:
        want = pickle.load(f)
    return {"ranks": ranks, "jax": want, "inputs": psum_inputs(4)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_compressed_psum_mean_is_bit_identical_to_jax(results):
    want = _leaves(results["jax"]["psum"])
    for r, (got, _) in enumerate(results["ranks"]):
        assert sorted(got["psum"]) == sorted(want)
        for k, a in want.items():
            np.testing.assert_array_equal(got["psum"][k], a,
                                          err_msg=f"{k} rank {r}")


def test_compressed_psum_mean_within_the_reference_bound(results):
    inputs = [_leaves(t) for t in results["inputs"]]
    got = results["ranks"][0][0]["psum"]
    for k in got:
        xs = np.stack([t[k] for t in inputs])
        exact = xs.mean(0)
        bound = 2 * np.abs(xs).max() / 127
        assert np.abs(got[k] - exact).max() <= bound, k


def test_dp_train_step_compressed_matches_jax(results):
    want = _leaves(results["jax"]["dp_grads"])
    for got, _ in results["ranks"]:
        np.testing.assert_allclose(got["dp_loss"], results["jax"]["dp_loss"],
                                   rtol=1e-6)
        for k, a in want.items():
            b = got["dp_grads"][k]
            assert np.abs(b - a).max() <= 2 * np.abs(a).max() / 127, k


def test_pipeline_matches_sequential_and_jax(results):
    ranks = [got for got, _ in results["ranks"]]
    for got in ranks:
        np.testing.assert_array_equal(got["piped"], ranks[0]["sequential"])
    np.testing.assert_allclose(ranks[0]["piped"], results["jax"]["piped"],
                               rtol=0, atol=1e-5)


def test_bubble_fraction_equals_the_reference(results):
    got = [tpipe.bubble_fraction(s, m) for s in (1, 2, 4, 8)
           for m in (1, 4, 8, 16)]
    assert got == results["jax"]["bubble"]


def test_megatron_collectives_match_the_unsharded_computation(results):
    for _, err in results["ranks"]:
        assert max(err.values()) <= 1e-12, err
