"""The port's checkpoint manager on the CPU: the save -> kill -> resume run
against the uninterrupted one (bit for bit), keep-k, atomicity, the async
save, the SIGTERM hook, and checkpoints read across the two packages.

Cross-package: the JAX package's ``CheckpointManager`` writes params and
AdamW state (float32 and int8 moments) after a JAX train step; the port
restores them bit for bit, and its next train step matches the JAX
package's next step within the train-step bound
(``torch_train_cases.assert_step_close``: loss and grad_norm relative
1e-5, each param's update 2e-2, measured 7.2e-3); and the
reverse, the port's checkpoint restored and stepped by the JAX package.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.train import optimizer as topt


def _state(seed=0, quantize=False):
    g = torch.Generator().manual_seed(seed)
    params = {"blocks": {"w": torch.randn((2, 1, 8, 12), generator=g)},
              "embed": torch.randn((20, 8), generator=g),
              "cross": [torch.randn((3,), generator=g)]}
    cfg = topt.AdamWConfig(quantize_moments=quantize, moment_block=16)
    opt = topt.init_state(params, cfg)
    grads = topt.map_params(lambda p: torch.randn(p.shape, generator=g),
                            params)
    topt.apply_updates(params, grads, opt, cfg)
    return {"params": params, "opt": opt}


def _assert_same(a, b):
    la, lb = topt.leaves(a), topt.leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("quantize", [False, True])
def test_restore_returns_the_saved_state_bit_for_bit(tmp_path, quantize):
    tree = _state(quantize=quantize)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    path = mgr.save(3, tree, metadata={"step": 3})
    assert path.endswith("step_3") and os.path.isdir(path)
    like = _state(seed=1, quantize=quantize)
    got, meta = mgr.restore(like)
    assert meta == {"step": 3}
    _assert_same(got, tree)
    if quantize:
        assert isinstance(got["opt"]["m"]["embed"], topt.QMoment)
    keys = np.load(os.path.join(path, "arrays.npz")).files
    assert "opt/step" in keys and "params/blocks/w" in keys
    assert ("opt/m/embed/.q" in keys) == quantize


def test_keep_k_collects_old_steps_after_a_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _state()
    for s in range(1, 6):
        mgr.save(s, tree)
        assert mgr.all_steps() == list(range(max(1, s - 1), s + 1))
    assert mgr.latest_step() == 5


def test_a_failed_save_publishes_nothing(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _state()
    mgr.save(1, tree)

    def crash(fd):
        raise OSError("disk lost mid-save")

    monkeypatch.setattr(os, "fsync", crash)
    with pytest.raises(OSError):
        mgr.save(2, tree)
    monkeypatch.undo()
    assert mgr.all_steps() == [1]
    assert not os.path.exists(tmp_path / "step_2")
    assert [n for n in os.listdir(tmp_path) if n.startswith("tmp.2.")]
    os.makedirs(tmp_path / "step_9")          # no manifest: not a checkpoint
    assert mgr.latest_step() == 1
    _assert_same(mgr.restore(_state(seed=4))[0], tree)


def test_async_save_and_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    tree = _state()
    mgr.save(4, tree)
    mgr.wait()
    assert mgr.all_steps() == [4]
    # the copy is taken at save(): a later in-place update does not reach
    # the checkpoint
    want = tree["params"]["embed"].clone()
    mgr.save(5, tree)
    tree["params"]["embed"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(_state(seed=2), step=5)
    assert torch.equal(got["params"]["embed"], want)
    # an error on the writer thread surfaces at wait()
    monkeypatch.setattr(np, "savez", lambda *a, **k: 1 / 0)
    mgr.save(6, tree)
    with pytest.raises(RuntimeError, match="background"):
        mgr.wait()
    assert mgr.all_steps() == [4, 5]


def test_sigterm_writes_a_final_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    tree = _state()
    old = signal.getsignal(signal.SIGTERM)
    try:
        mgr.save_on_signal(lambda: (7, tree))
        with pytest.raises(SystemExit) as e:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(5)
        assert e.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, old)
    got, meta = mgr.restore(_state(seed=3))
    assert meta == {"preempted": True}
    _assert_same(got, tree)


def test_leaves_of_another_dtype_are_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    mgr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="like tree"):
        mgr.restore({"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"v": torch.zeros(3)})


# ----------------------------------------------------------------------------
# save -> kill -> resume through the CLI
# ----------------------------------------------------------------------------
class Killed(Exception):
    pass


def _train(ckpt_dir, *extra):
    return train_cli.main([
        "--arch", "stablelm-1.6b", "--smoke", "--device", "cpu", "--steps",
        "8", "--batch", "2", "--seq", "16", "--lr", "3e-3", "--ckpt-dir",
        str(ckpt_dir), "--ckpt-every", "2", *extra])


def test_kill_and_resume_is_bit_identical_to_the_uninterrupted_run(
        tmp_path, monkeypatch):
    whole = _train(tmp_path / "whole")
    nxt = tpipe.DataLoader.__next__

    def killed_at_5(self):
        if self.step == 5:
            raise Killed
        return nxt(self)

    monkeypatch.setattr(tpipe.DataLoader, "__next__", killed_at_5)
    with pytest.raises(Killed):
        _train(tmp_path / "cut")
    for t in threading.enumerate():          # the in-flight async save
        if "_write_async" in t.name:
            t.join()
    monkeypatch.undo()
    resumed = _train(tmp_path / "cut", "--resume")
    assert resumed["steps"] == 4                # from step_3: steps 4..7
    assert resumed["last_loss"] == whole["last_loss"]
    like = {"params": train_cli.api.init_params(
        train_cli.get_config("stablelm-1.6b").reduced(),
        torch.Generator().manual_seed(9), "cpu")}
    like["opt"] = topt.init_state(like["params"], topt.AdamWConfig())
    a, _ = CheckpointManager(str(tmp_path / "whole")).restore(like, step=7)
    b, _ = CheckpointManager(str(tmp_path / "cut")).restore(like, step=7)
    _assert_same(a, b)
    assert int(a["opt"]["step"]) == 8


# ----------------------------------------------------------------------------
# across the two packages
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("quantize", [False, True])
def test_checkpoints_cross_read_between_the_packages(tmp_path, quantize):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.ckpt.manager import CheckpointManager as JaxManager
    from repro.train import optimizer as jopt
    from repro.train import step as jstep
    from repro_torch.models.api import opt_state_from_numpy
    from repro_torch.models.api import params_from_numpy
    from repro_torch.train import step as tstep
    from torch_train_cases import (assert_step_close, auto_mesh, configs,
                                   jax_batch, jax_leaves, numpy_batch,
                                   numpy_params, numpy_state)

    mesh = auto_mesh()
    cfg, tcfg = configs("stablelm-1.6b", dtype="float32")
    optkw = dict(lr=1e-2, warmup_steps=2, total_steps=4,
                 quantize_moments=quantize, moment_block=64)
    jcfg, tocfg = jopt.AdamWConfig(**optkw), topt.AdamWConfig(**optkw)
    tree = numpy_params(cfg)
    batches = [numpy_batch(cfg, seed=20 + i) for i in range(3)]
    with mesh:
        jp = jax.tree.map(jnp.asarray, tree)
        js = jopt.init_state(jp, jcfg)
        jfn = jstep.make_train_step(cfg, jcfg, mesh, jp, js)
        jp, js, _ = jfn(jp, js, jax_batch(batches[0]))
        JaxManager(str(tmp_path / "j")).save(0, {"params": jp, "opt": js},
                                             metadata={"step": 0})
    # the port restores the JAX package's checkpoint bit for bit ...
    like = {"params": params_from_numpy(tree, "cpu")}
    like["opt"] = topt.init_state(like["params"], tocfg)
    got, meta = CheckpointManager(str(tmp_path / "j")).restore(like)
    assert meta == {"step": 0}
    want = dict(jax_leaves({"params": jp, "opt": js}))
    for key, t in topt.leaves(got):
        np.testing.assert_array_equal(t.numpy(), want[key], err_msg=key)
    carried = {"params": params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"),
               "opt": opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                           "cpu")}
    _assert_same(got, carried)
    # ... and its next step is the JAX package's next step
    tfn = tstep.make_train_step(tcfg, tocfg)
    tp, ts, tm = tfn(got["params"], got["opt"], batches[1])
    with mesh:
        jp, js, jm = jfn(jp, js, jax_batch(batches[1]))
    assert_step_close(jp, jm, tp, tm, want)
    # the reverse: the port's checkpoint, restored and stepped by the JAX
    # package, against the port's own next step
    CheckpointManager(str(tmp_path / "t")).save(
        1, {"params": tp, "opt": ts}, metadata={"step": 1})
    with mesh:
        jlike = {"params": jp, "opt": js}
        back, meta = JaxManager(str(tmp_path / "t")).restore(jlike)
        assert meta == {"step": 1} and int(back["opt"]["step"]) == 2
        port_now = dict(topt.leaves({"params": tp, "opt": ts}))
        for key, a in jax_leaves(back):
            np.testing.assert_array_equal(a, port_now[key].detach().numpy(),
                                          err_msg=key)
        before = dict(jax_leaves(back))
        jp2, js2, jm2 = jfn(jax.tree.map(jnp.asarray, back["params"]),
                            jax.tree.map(jnp.asarray, back["opt"]),
                            jax_batch(batches[2]))
    tp, ts, tm = tfn(tp, ts, batches[2])
    assert_step_close(jp2, jm2, tp, tm, before)
    assert numpy_state(ts)["step"] == int(js2["step"]) == 3

