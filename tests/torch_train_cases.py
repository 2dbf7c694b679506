"""Shared makers of the training parity tests: the same seeded numpy params,
batches and optimizer state for the JAX package and the port.  Imported
only by files that have called ``pytest.importorskip("jax")``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.api import params_from_numpy
from repro_torch.train import optimizer as topt

# one config of each family the port's forward runs: dense, windowed with
# softcaps, MoE, rwkv, hymba, the VLM (cross gates set non-zero: a zero
# gate hides the cross path) and the encoder-decoder
FAMILIES = ("stablelm-1.6b", "gemma2-27b", "phi3.5-moe-42b-a6.6b",
            "rwkv6-7b", "hymba-1.5b", "llama-3.2-vision-11b",
            "seamless-m4t-medium")
GATES = (0.7, -0.9)


def auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def configs(arch, **kw):
    """The reduced JAX and port configs of ``arch`` with ``kw`` replaced in
    both (``use_pallas`` in the JAX one only)."""
    pallas = kw.pop("use_pallas", False)
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=pallas,
                              **kw)
    tcfg = dataclasses.replace(t_get_config(arch).reduced(), **kw)
    return cfg, tcfg


def numpy_params(cfg, seed=0):
    """The JAX package's seeded init params as numpy (a VLM's cross gates
    set to ``GATES``)."""
    tree = jax.tree.map(np.asarray, jax.jit(
        japi.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(seed)))
    if cfg.cross_attn_every:
        tree["cross"]["gate"] = np.asarray(GATES, np.float32)
    return tree


def numpy_batch(cfg, B=2, T=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((B, T)) < 0.9).astype(np.float32)}
    if cfg.frontend_tokens:
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def trainable(tree):
    """Port params (CPU) from a numpy tree, every tensor requiring grad."""
    params = params_from_numpy(tree, "cpu")
    for _, t in topt.leaves(params):
        t.requires_grad_(True)
    return params


def jax_leaves(tree):
    """``(path, numpy leaf)`` in the JAX package's flatten order and path
    strings (``ckpt/manager.py::_flatten_with_paths``)."""
    from repro.ckpt.manager import _flatten_with_paths
    return [(k, np.asarray(v)) for k, v in _flatten_with_paths(tree)]


def rel_errors(jax_tree, port_tree):
    """Per-leaf relative norm error ||port - jax|| / ||jax|| (float32)."""
    port = dict(topt.leaves(port_tree))
    out = {}
    for key, a in jax_leaves(jax_tree):
        b = port[key].detach().to(torch.float32).numpy()
        a = a.astype(np.float32)
        out[key] = float(np.linalg.norm(b - a) / max(np.linalg.norm(a),
                                                       1e-30))
    return out


def numpy_state(state):
    """The port's AdamW state as the JAX package's numpy tree (an int8
    moment as its ``_QMoment``)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, topt.QMoment):
            return jopt._QMoment(node.q.numpy(), node.scale.numpy())
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return node.detach().numpy()

    return {"step": np.asarray(state["step"].numpy(), np.int32),
            "m": conv(state["m"]), "v": conv(state["v"])}


def assert_step_close(jp, jm, tp, tm, before):
    """A port train step against the JAX package's from the same params and
    state (``before``: the params' ``path -> numpy`` before the step): loss
    and grad_norm within a relative 1e-5; each param leaf's update (after -
    before) within a relative norm error of 2e-2.  The bound is loose
    because AdamW divides by sqrt(v): where ``b1 m`` nearly cancels ``(1 -
    b1) g``, the gradients' float32 sum-order differences (relative 1e-6)
    reach the update amplified."""
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    port = dict(topt.leaves({"params": tp}))
    for key, a in jax_leaves({"params": jp}):
        d_j = a - before[key]
        d_t = port[key].detach().numpy() - before[key]
        err = np.linalg.norm(d_t - d_j) / max(np.linalg.norm(d_j), 1e-30)
        assert err <= 2e-2, (key, err)
