"""The port's serving CLI, ``python -m repro_torch.launch.serve``, on the
CPU at the reduced size: both modes print their JSON report, the KV-cache
feature flags serve, flags of features the port does not have yet exit
with "not ported yet", and the default device needs a card.  Imports neither JAX nor the JAX package."""
import json

import pytest
import torch

from repro_torch.launch import serve

SMOKE = ["--smoke", "--device", "cpu", "--max-new", "4"]


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["llama2-7b", "tinyllama-1.1b",
                                  "gemma2-27b", "granite-8b"])
def test_continuous_paged_and_dense_reports(arch, capsys):
    out = serve.main(["--arch", arch, *SMOKE, "--continuous",
                      "--requests", "5", "--slots", "2", "--page-size", "8"])
    rep = _report(capsys)
    assert rep["arch"] == arch + "-smoke" and rep["device"] == "cpu"
    assert set(rep["matmul"]) == {"allow_tf32", "cudnn_allow_tf32",
                                  "allow_bf16_reduced_precision_reduction"}
    assert rep["by_state"] == {"DONE": 5} and rep["gen_len"] == [4] * 5
    assert rep["cache"]["page_size"] == 8 and rep["cache"]["pages_in_use"] == 0
    paged = [r.tokens.tolist() for r in out["results"]]
    out = serve.main(["--arch", arch, *SMOKE, "--continuous",
                      "--requests", "5", "--slots", "2"])
    rep = _report(capsys)
    assert "cache" not in rep and rep["decoded_tokens"] == 20
    assert [r.tokens.tolist() for r in out["results"]] == paged


def test_generate_report_with_eos(capsys):
    out = serve.main(["--arch", "llama2-7b", *SMOKE, "--batch", "3",
                      "--prompt-len", "6", "--eos-id", "7"])
    rep = _report(capsys)
    assert rep["batch"] == 3 and len(rep["gen_len"]) == 3
    assert out["tokens"].shape == (3, 4)


@pytest.mark.parametrize("flags", [
    ["--kv-dtype", "int8"], ["--kv-dtype", "fp8"], ["--prefix-cache", "on"],
    ["--prefill-chunk", "8"], ["--paged-attn", "gather"]])
def test_ported_feature_flags_serve(flags, capsys):
    """The KV-cache feature flags serve on the smoke config, each alone
    and all together, with the tokens of the plain paged run: prefix reuse
    and chunked prefill change what is computed, not the tokens; the
    gather discipline computes the same attention; a quantized pool stores
    int8 / fp8 pages with their scales."""
    common = ["--arch", "llama2-7b", *SMOKE, "--continuous", "--requests",
              "5", "--slots", "2", "--page-size", "8"]
    plain = [r.tokens.tolist() for r in serve.main(common)["results"]]
    _report(capsys)
    for extra in (flags, ["--prefix-cache", "on", "--prefill-chunk", "8",
                          "--paged-attn", "gather", *flags]):
        out = serve.main(common + extra)
        rep = _report(capsys)
        assert rep["by_state"] == {"DONE": 5} and rep["gen_len"] == [4] * 5
        assert rep["cache"]["pages_in_use"] == 0
        kv = flags[1] if flags[0] == "--kv-dtype" else "bf16"
        assert rep["cache"]["kv_dtype"] == kv
        if kv == "bf16":
            assert [r.tokens.tolist() for r in out["results"]] == plain


@pytest.mark.parametrize("flags", [
    ["--tp", "2"], ["--priority", "0,1"], ["--deadline-s", "5"],
    ["--preemption", "on"], ["--chaos-plan", "device_loss_at=3"],
    ["--recovery-log", "x.json"]])
def test_unported_flags_exit(flags, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "llama2-7b", *SMOKE, "--continuous",
                    "--page-size", "8", *flags])
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


def test_unported_arch_exits(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--arch", "hymba-1.5b", *SMOKE])
    assert "not ported yet" in capsys.readouterr().err


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2-7b", "--smoke"])
