"""The port's serving CLI, ``python -m repro_torch.launch.serve``, on the
CPU at the reduced size: both modes print their JSON report, the KV-cache
feature flags serve, ``--tp 2`` serves on two gloo ranks with the tokens of
``--tp 1`` (with the online and chaos flags, the MoE configs and
``generate()`` too; only rank 0 writes ``--recovery-log``), the frontend
configs serve through generate() only, a name outside the registry exits
with "not ported yet", and the default device needs a card.  Imports
neither JAX nor the JAX package."""
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
    ["--tp", "2", "--chaos-plan", "device_loss_at=4"],
    ["--tp", "2", "--priority", "0,1"],
    ["--tp", "2", "--arch", "phi3.5-moe-42b-a6.6b"]])
def test_unported_flags_exit(flags, capsys):
    """The combinations that earlier slices refused under ``--tp`` (the
    online and chaos flags, the MoE configs) serve on two gloo ranks now:
    rank 0's report has the tokens and request states of ``--tp 1`` (a
    device loss recovered on both ranks alike)."""
    args = ["--arch", "llama2-7b", *SMOKE, "--continuous", "--requests",
            "4", "--slots", "2", "--page-size", "8", *flags[2:]]
    serve.main(args)
    one = _report(capsys)
    out = serve.main(args + flags[:2])
    two = _report(capsys)
    assert two["tp"] == 2 and two["tokens"] == one["tokens"] == out["tokens"]
    assert two["by_state"] == one["by_state"] == {"DONE": 4}
    assert two.get("chaos") is None or (
        two["chaos"]["fired"] == one["chaos"]["fired"] == {"device_loss": 1})


def test_tp_without_continuous_exits(capsys):
    """``--tp 2`` without ``--continuous`` runs ``generate()`` on the two
    ranks: rank 0's report has the tokens of ``--tp 1``."""
    args = ["--arch", "llama2-7b", *SMOKE, "--batch", "3"]
    one = serve.main(args)
    rep1 = _report(capsys)
    out = serve.main(args + ["--tp", "2"])
    rep2 = _report(capsys)
    assert out["tokens"] == one["tokens"].tolist()
    assert rep2["generated"] == rep1["generated"] and rep2["tp"] == 2


def test_tp_recovery_log_written_once_by_rank_0(capsys, tmp_path):
    """Under ``--tp 2`` only rank 0 writes ``--recovery-log``; its events
    are those of ``--tp 1`` (without their seconds), and the ranks agree
    on them."""
    log = tmp_path / "events.json"
    args = ["--arch", "llama2-7b", *SMOKE, "--continuous", "--requests",
            "4", "--slots", "2", "--page-size", "8", "--chaos-plan",
            "step_corrupt_at=2,step_corrupt_iters=2,device_loss_at=6",
            "--recovery-log", str(log)]
    serve.main(args)
    _report(capsys)
    one = json.loads(log.read_text())
    log.unlink()
    out = serve.main(args + ["--tp", "2"])
    rep = _report(capsys)
    assert out["log_writers"] == [0] and rep["recovery_log"] == str(log)
    two = json.loads(log.read_text())

    def strip(events):
        return [{k: v for k, v in e.items() if k != "recovery_s"}
                for e in events]

    assert strip(two) == strip(one) == out["events"]
    assert {e["event"] for e in two} == {"quarantine", "recover"}


def test_tp2_reports_the_tokens_of_tp1(capsys):
    """``--tp 2`` on the CPU: two gloo ranks serve the same requests over
    their shards, and rank 0's report has the tokens of ``--tp 1``, with
    the group's backend and devices and the pool's KV heads cut in two."""
    args = ["--arch", "llama2-7b", *SMOKE, "--continuous", "--requests",
            "4", "--slots", "2", "--page-size", "8"]
    serve.main(args + ["--tp", "1"])
    one = _report(capsys)
    out = serve.main(args + ["--tp", "2"])
    two = _report(capsys)
    assert one["tp"] == 1 and two["tp"] == 2
    assert two["tp_backend"] == "gloo" and two["tp_devices"] == ["cpu"] * 2
    assert two["tokens"] == one["tokens"] == out["tokens"]
    assert two["gen_len"] == [4] * 4 and two["by_state"] == {"DONE": 4}
    assert one["cache"]["kv_shards"] == 1 and two["cache"]["kv_shards"] == 2


def test_unported_arch_exits(capsys):
    """Every config of the registry is served now: a name outside it."""
    with pytest.raises(SystemExit):
        serve.main(["--arch", "t5-small", *SMOKE])
    assert "not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_frontend_configs_serve_generate_only(arch, capsys):
    """The VLM and the encoder-decoder config serve through generate() with
    a seeded frontend, the same tokens on a second call; ``--continuous``
    exits with the engine's refusal of their slot caches."""
    args = ["--arch", arch, *SMOKE, "--batch", "3", "--prompt-len", "5"]
    out = serve.main(args)
    rep = _report(capsys)
    assert rep["arch"] == arch + "-smoke" and rep["gen_len"] == [4] * 3
    assert out["tokens"].shape == (3, 4)
    assert (serve.main(args)["tokens"] == out["tokens"]).all()
    _report(capsys)
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", arch, *SMOKE, "--continuous"])
    assert e.value.code == 2
    assert "not slot-servable" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_serves(arch, capsys):
    serve.main(["--arch", arch, *SMOKE, "--continuous", "--requests", "5",
                "--slots", "4", "--page-size", "8"])
    rep = _report(capsys)
    assert rep["arch"] == arch + "-smoke"
    assert rep["by_state"] == {"DONE": 5} and rep["gen_len"] == [4] * 5
    assert rep["cache"]["pages_in_use"] == 0
    out = serve.main(["--arch", arch, *SMOKE, "--batch", "3"])
    assert out["tokens"].shape == (3, 4)


@pytest.mark.parametrize("flags", [
    ["--priority", "0,1"], ["--deadline-s", "30"], ["--preemption", "on"],
    ["--chaos-plan", "device_loss_at=3"], ["--chaos-seed", "5"],
    ["--recovery-log", "RECOVERY_LOG"]])
def test_online_and_chaos_flags_serve(flags, capsys, tmp_path):
    """The online-serving and chaos flags serve on the smoke config: SLA
    classes, a generous deadline and armed preemption with nothing to evict
    give the plain run's tokens; a device loss at iteration 3 is recovered
    with the same tokens; ``--recovery-log`` writes the event stream as
    JSON."""
    common = ["--arch", "llama2-7b", *SMOKE, "--continuous", "--requests",
              "5", "--slots", "2", "--page-size", "8"]
    plain = [r.tokens.tolist() for r in serve.main(common)["results"]]
    _report(capsys)
    log = tmp_path / "events.json"
    flags = [str(log) if f == "RECOVERY_LOG" else f for f in flags]
    if flags[0] == "--recovery-log":
        flags += ["--chaos-plan", "step_corrupt_at=2,step_corrupt_iters=2"]
    out = serve.main(common + flags)
    rep = _report(capsys)
    assert rep["by_state"] == {"DONE": 5} and rep["gen_len"] == [4] * 5
    assert rep["preemptions"] == 0 and rep["cache"]["pages_in_use"] == 0
    assert [r.tokens.tolist() for r in out["results"]] == plain
    if flags[0] == "--chaos-plan":
        assert rep["chaos"]["fired"] == {"device_loss": 1}
        assert rep["chaos"]["recoveries"] == 1 and rep["chaos"]["seed"] == 0
    if flags[0] == "--recovery-log":
        events = json.loads(log.read_text())
        assert rep["chaos"]["quarantines"] >= 1
        assert [e["event"] for e in events] == (
            ["quarantine"] * rep["chaos"]["quarantines"])


def test_zero_deadline_times_every_request_out(capsys):
    serve.main(["--arch", "llama2-7b", *SMOKE, "--continuous", "--requests",
                "4", "--slots", "2", "--page-size", "8", "--deadline-s", "0"])
    rep = _report(capsys)
    assert rep["by_state"] == {"TIMEOUT": 4} and rep["decoded_tokens"] == 0
    assert rep["cache"]["pages_in_use"] == 0


@pytest.mark.parametrize("bad, message", [
    ("bogus=1", "unknown or malformed entry"),
    ("device_loss_at", "unknown or malformed entry"),
    ("device_loss_at=x", "bad value"),
    (",", "named no fault points")])
def test_bad_chaos_plan_entries_exit(bad, message, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "llama2-7b", *SMOKE, "--continuous",
                    "--chaos-plan", bad])
    assert e.value.code == 2 and message in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--priority", "0,1"], ["--chaos-plan", "device_loss_at=3"],
    ["--priority", "a,b"]])
def test_online_flags_need_continuous_or_integers(flags, capsys):
    args = ["--arch", "llama2-7b", *SMOKE, *flags]
    if flags[1] == "a,b":
        args.append("--continuous")
    with pytest.raises(SystemExit) as e:
        serve.main(args)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("integers" if flags[1] == "a,b" else "--continuous") in err


@pytest.mark.parametrize("extra", [[], ["--continuous", "--requests", "4",
                                        "--slots", "2"]],
                         ids=["generate", "continuous"])
def test_hymba_serves(extra, capsys):
    out = serve.main(["--arch", "hymba-1.5b", *SMOKE, "--prompt-len", "20",
                      *extra])
    rep = _report(capsys)
    assert rep["arch"] == "hymba-1.5b-smoke"
    if extra:
        assert rep["by_state"] == {"DONE": 4} and "cache" not in rep
    else:
        assert out["tokens"].shape == (4, 4)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama2-7b", "--smoke"])
