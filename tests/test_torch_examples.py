"""The port's examples (``examples/*_torch.py``) against what the JAX
package's examples compute.

The JAX examples build their engines on the default mesh, which fails on
the installed JAX, so this file runs their statements on an Auto-axis mesh
(as ``tests/test_torch_splitbrain_generate.py`` builds the reference) at the
examples' reduced sizes, and runs each port example's ``run()`` on the CPU
on the same weights (``params_from_numpy``):

  quickstart        tinyllama-1.1b reduced (vocab 512): the LAQ codes of
                    ``wq`` and their pruned share, the 8 greedy tokens of
                    ``decode_token`` from token 1, the meter's bytes per
                    token against eq. 7-10, and the full-size hardware
                    report (gates, energy, area, cost, interface table):
                    all equal
  serve_splitbrain  llama2-7b reduced (vocab 512), 4 prompts of 5 tokens, 12
                    new: the float ``jit=True`` tokens against ``fused=True``,
                    ``jit=False`` against ``fused=False``, the LAQ W4A8
                    engine's against the port's, the batch-4 meter bytes
                    against eq. 7-10, and Table III: all equal

Each ``main(["--device", "cpu"])`` runs and prints the JAX example's lines,
and raises without a card when no device is given; ``train_e2e_torch.run``
trains, checkpoints and resumes."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config
from repro.core import costmodel as jcost
from repro.models import api as japi
from repro.serve.splitbrain_engine import SplitBrainEngine as JEngine
from repro.serve.splitbrain_engine import traffic_model_for as jtraffic
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.api import params_from_numpy
from torch_cases import load_example

quickstart = load_example("quickstart_torch")
serve_splitbrain = load_example("serve_splitbrain_torch")
train_e2e = load_example("train_e2e_torch")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _setup(arch):
    cfg = get_config(arch).reduced(vocab_size=512)
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, params, t_get_config(arch).reduced(vocab_size=512), tparams


@pytest.fixture(scope="module")
def quick():
    """``examples/quickstart.py``'s statements and the port's ``run``."""
    cfg, params, tcfg, tparams = _setup("tinyllama-1.1b")
    # the example quantizes the whole tree and reads wq's codes; LAQ works
    # leaf by leaf, so the wq leaf alone gives the same codes, 4x faster
    qparams = japi.quantize_model(
        {"blocks": {"attn": {"wq": params["blocks"]["attn"]["wq"]}}}, cfg)
    codes = np.asarray(qparams["blocks"]["attn"]["wq"].codes).ravel()
    eng = JEngine(cfg, params, max_len=32, mesh=_mesh())
    cache = eng.init_cache(batch=1)
    tok = jnp.asarray([1], jnp.int32)
    generated = []
    for _ in range(8):
        tok, _, cache = eng.decode_token(cache, tok)
        generated.append(int(tok[0]))
    full = get_config("tinyllama-1.1b")
    n = full.param_count()
    tm_full = jtraffic(full)
    ref = {"codes": codes, "pruned": float((codes == 0).mean()),
           "tokens": generated,
           "measured_bytes_per_token":
               eng.measured_bytes_per_token(batch=1)["total"] // 8,
           "model_bytes_per_token": jtraffic(cfg).bytes_per_token(),
           "report": {"arch": full.name, "params": n,
                      "gates": jcost.gate_reduction(codes),
                      "energy": jcost.energy_comparison(codes),
                      "area": jcost.die_area_mm2(n),
                      "cost": jcost.unit_cost(n),
                      "bytes_per_token": tm_full.bytes_per_token(),
                      "bandwidth_bytes_per_s_at_20":
                          tm_full.bandwidth_bytes_per_s(20),
                      "interface_table": tm_full.interface_table()}}
    return ref, quickstart.run(tcfg, tparams, device="cpu")


def test_quickstart_codes_and_pruned_share_equal_the_reference(quick):
    ref, ours = quick
    assert ours["codes"].dtype == torch.int8
    np.testing.assert_array_equal(ours["codes"].numpy(), ref["codes"])
    assert ours["pruned"] == ref["pruned"]


def test_quickstart_tokens_and_meter_equal_the_reference(quick):
    ref, ours = quick
    assert ours["tokens"] == ref["tokens"]
    assert ours["logits"].shape == (8, 512)
    assert ours["logits"].argmax(dim=1).tolist() == ref["tokens"]
    assert ours["measured_bytes_per_token"] == ref["measured_bytes_per_token"]
    assert ours["measured_bytes_per_token"] == ours["model_bytes_per_token"]
    assert ours["model_bytes_per_token"] == ref["model_bytes_per_token"]


def test_quickstart_report_equals_the_reference(quick):
    ref, ours = quick
    assert ours["report"] == ref["report"]
    assert repr(ours["report"]) == repr(ref["report"])
    assert ours["model"] == {"name": "tinyllama-1.1b-smoke", "layers": 2,
                             "d_model": 64}


SERVE_NEW = 12


@pytest.fixture(scope="module")
def serve():
    """``examples/serve_splitbrain.py``'s statements and the port's
    ``run``."""
    cfg, params, tcfg, tparams = _setup("llama2-7b")
    mesh = _mesh()
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 5)).astype(np.int32)
    jp = jnp.asarray(prompts)
    eng_f = JEngine(cfg, params, max_len=64, quantize=False, mesh=mesh)
    eng_f.generate(jp, max_new=SERVE_NEW)
    out_f = np.asarray(eng_f.generate(jp, max_new=SERVE_NEW)["tokens"])
    eng_e = JEngine(cfg, params, max_len=64, quantize=False, jit=False,
                    mesh=mesh)
    out_e = np.asarray(eng_e.generate(jp, max_new=SERVE_NEW)["tokens"])
    eng_q = JEngine(cfg, params, max_len=64, quantize=True, mesh=mesh)
    out_q = np.asarray(eng_q.generate(jp, max_new=SERVE_NEW)["tokens"])
    eng_q.meter.reset()
    eng_q.decode_token(eng_q.init_cache(4), jp[:, 0])
    ref = {"tokens": {"float_fused": out_f, "float_stepwise": out_e,
                      "w4a8": out_q},
           "measured_bytes_per_token":
               eng_q.measured_bytes_per_token(batch=4)["total"],
           "model_bytes_per_token": jtraffic(cfg).bytes_per_token(),
           "interface_table": jtraffic(
               get_config("llama2-7b")).interface_table()}
    return ref, serve_splitbrain.run(tcfg, tparams, prompts, device="cpu")


@pytest.mark.parametrize("run", ["float_fused", "float_stepwise", "w4a8"])
def test_serve_tokens_equal_the_reference(serve, run):
    ref, ours = serve
    got = ours["tokens"][run]
    assert got.dtype == np.int32 and got.shape == (4, SERVE_NEW)
    np.testing.assert_array_equal(got, ref["tokens"][run])


def test_serve_meter_agreements_and_table_equal_the_reference(serve):
    ref, ours = serve
    assert ours["measured_bytes_per_token"] == ref["measured_bytes_per_token"]
    assert ours["measured_bytes_per_token"] == ours["model_bytes_per_token"]
    assert ours["model_bytes_per_token"] == ref["model_bytes_per_token"]
    assert ours["interface_table"] == ref["interface_table"]
    t = ref["tokens"]
    assert ours["float_w4a8_agreement"] == float(
        (t["float_fused"] == t["w4a8"]).mean())
    assert ours["fused_stepwise_agreement"] == float(
        (t["float_fused"] == t["float_stepwise"]).mean())
    # each part's kernel launches: none on the CPU, where the plain
    # versions run
    assert set(ours["launches"]) == {"float_warmup", "float_fused",
                                     "float_stepwise", "w4a8",
                                     "w4a8_decode_token"}
    assert not any(v for part in ours["launches"].values()
                   for v in part.values())


@pytest.mark.parametrize("example,lines", [
    (quickstart, ["model: tinyllama-1.1b-smoke (2L d=64)",
                  "LAQ: ", "generated tokens: [",
                  "interface traffic: measured 1536 B/token (analytical "
                  "1536 B/token)",
                  "=== ITA hardware report: tinyllama-1.1b (1.10B params) ===",
                  "gates/MAC:", "energy/MAC:", "die area:         520 mm^2 "
                  "(monolithic)", "unit cost:", "interface:",
                  "  PCIe 3.0 x4", "  USB 4.0"]),
    (serve_splitbrain, ["== float device weights", "4 requests x 12 tokens",
                        "== eager per-layer reference loop",
                        "== LAQ INT4 'hardwired' device weights ==",
                        "token agreement float vs W4A8:",
                        "per-token interface bytes (per request): measured "
                        "1792 vs analytical 1792",
                        "full-size llama2-7b deployment table (Table III):",
                        "  PCIe 3.0 x4", "  USB 4.0"]),
], ids=["quickstart", "serve_splitbrain"])
def test_main_on_the_cpu_prints_the_examples_lines(example, lines, capsys):
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    for want in lines:
        assert any(line.startswith(want) for line in out), (want, out)


@pytest.mark.parametrize("example", [quickstart, serve_splitbrain, train_e2e],
                         ids=["quickstart", "serve_splitbrain", "train_e2e"])
def test_main_raises_without_a_card(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])


def test_train_e2e_trains_checkpoints_and_resumes(tmp_path, capsys):
    """40 steps: the first phase saves at step 19 (every 20), the second
    resumes from it and trains steps 20-39, and the loss drops."""
    # one thread: the steps' small ops oversubscribe the cores when the
    # test files run in parallel (40 steps took 365 s there with every
    # core's thread, 2-3 s alone)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = train_e2e.run("granite-8b", 40, device="cpu",
                          ckpt_dir=str(tmp_path))
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "resumed from step 19" in out
    assert r["phase1"]["steps"] == 20 and r["phase2"]["steps"] == 20
    assert r["drop"] == r["first_loss"] - r["last_loss"] > 0.5
