"""Cases and rank bodies of the distributed-training tests: seeded numpy
inputs that the JAX package and the port both read, and module-level
functions that ``repro_torch.distributed.runtime.spawn`` runs on every rank
of a gloo grid on the CPU.  Imports neither JAX nor the JAX package: the
ranks are new processes, and the JAX side of each comparison runs in a
subprocess of the test."""
import dataclasses

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import collectives, pipeline
from repro_torch.models import api
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ARCH = "granite-8b"
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=4)
BLOCK = 256
# the int8 reduction's leaves: 300 and 7 elements pad their last block
PSUM_SHAPES = {"a": (3, 100), "b": (7,), "c": {"w": (64, 48)}}
PIPE = dict(stages=4, microbatches=8, mb=4, width=32)


# The configs of tensor-parallel training at tp 2: name -> (arch, overrides
# of the reduced config, a MoE's (experts, top-k) among them).  rwkv6 at
# d_model 128 (two heads of 64, one a rank; the reduced width has one);
# qwen3-moe with 16 experts and top-8; and two configs where the group's
# size divides no head count: hymba at 5/1 heads as hymba-1.5b's 25/5 (every
# head on every rank) with a vocabulary of 257 (its 32,001 keeps the head
# whole) and a d_model of 63 (the SSM branch whole on every rank), and
# rwkv6 at its reduced width (one head: the whole layer on every rank).
TP_FAMILIES = {
    "rwkv6": ("rwkv6-7b", {"d_model": 128}),
    "hymba": ("hymba-1.5b", {}),
    "seamless": ("seamless-m4t-medium", {}),
    "phi_moe": ("phi3.5-moe-42b-a6.6b", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "qwen_moe": ("qwen3-moe-235b-a22b", {"moe": (16, 8)}),
    "hymba_whole": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 1,
                                   "vocab_size": 257, "d_model": 63}),
    "rwkv6_whole": ("rwkv6-7b", {}),
}


def port_cfg(arch=ARCH, **kw):
    if isinstance(kw.get("moe"), tuple):
        kw["moe"] = MoEConfig(*kw["moe"])
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def numpy_batch(vocab, B=4, T=16, seed=1, frontend=None):
    """A train batch (tokens, labels, a mask with about 10 % zeros)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": (rng.random((B, T)) < 0.9).astype(np.float32)}
    if frontend is not None:
        batch["frontend"] = rng.standard_normal(
            (B,) + tuple(frontend)).astype(np.float32)
    return batch


def psum_inputs(n, seed=5):
    """Rank r's tree of the int8 reduction's inputs, for r < n: gradient-like
    values spanning a few decades, so that blocks take unlike scales."""
    rng = np.random.default_rng(seed)

    def make(shape):
        if isinstance(shape, dict):
            return {k: make(v) for k, v in shape.items()}
        return (rng.standard_normal(shape)
                * np.exp(rng.uniform(-4, 1, shape))).astype(np.float32)

    return [make(PSUM_SHAPES) for _ in range(n)]


def pipe_inputs(seed=6):
    """Stage weights (S, width, width) and microbatches (M, mb, width)."""
    rng = np.random.default_rng(seed)
    S, M, mb, w = (PIPE[k] for k in ("stages", "microbatches", "mb",
                                     "width"))
    ws = (rng.standard_normal((S, w, w)) / np.sqrt(w)).astype(np.float32)
    x = rng.standard_normal((M, mb, w)).astype(np.float32)
    return ws, x


def stage(w, x):
    return torch.tanh(x @ w)


def sequential(ws, x):
    """The stages applied one after another to each microbatch."""
    out = []
    for m in range(x.shape[0]):
        y = x[m]
        for w in ws:
            y = stage(w, y)
        out.append(y)
    return torch.stack(out)


def _tree(a):
    if isinstance(a, dict):
        return {k: _tree(v) for k, v in a.items()}
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy(tree):
    return {k: t.detach().cpu().numpy().copy() for k, t in topt.leaves(tree)}


# ----------------------------------------------------------------------------
# The collectives' rank body (a (2, 2) grid)
# ----------------------------------------------------------------------------
def collectives_rank(grid, params, batch):
    """On this rank: the int8 reduction over the world (4 ranks), the
    pipeline over the world as its "pipe" group, and
    ``dp_train_step_compressed`` over the "data" group on ``params`` (the
    JAX package's granite-8b reduced, numpy) with this data rank's rows of
    ``batch``.  Returns numpy results."""
    torch.set_num_threads(1)
    world = grid.world
    mine = _tree(psum_inputs(world.size)[world.rank])
    psum = collectives.compressed_psum_mean(mine, world, BLOCK)
    ws, x = pipe_inputs()
    ws, x = torch.from_numpy(ws), torch.from_numpy(x)
    run = pipeline.pipeline_apply(world, stage, PIPE["microbatches"])
    piped = run(ws[world.rank], x)
    cfg = port_cfg(dtype="float32")
    p = api.params_from_numpy(params, "cpu")
    d, n = grid.data.rank, grid.data.size
    rows = {k: torch.from_numpy(v[d * len(v) // n:(d + 1) * len(v) // n])
            for k, v in batch.items()}
    fn = collectives.dp_train_step_compressed(
        lambda p_, b: api.loss_fn(p_, b, cfg), grid.data, BLOCK)
    loss, grads = fn(p, rows)
    return {"psum": _numpy(psum), "piped": piped.numpy(),
            "sequential": sequential(ws, x).numpy(),
            "dp_loss": float(loss), "dp_grads": _numpy(grads)}


def functions_rank(grid, seed=7):
    """Megatron's collectives over the "model" group against the same
    computation unsharded in this process: a column-cut then row-cut MLP
    (``copy_to``, ``row_linear``), a gathered column block
    (``gather_from``), a rows gather whose consumers differ by rank
    (``gather_sum`` over "data"), and the vocabulary-parallel
    cross-entropy.  Returns the largest differences of the values and of
    every input's gradient."""
    from repro_torch.models import layers as L
    torch.set_num_threads(1)
    torch.manual_seed(seed)
    model, data = grid.model, grid.data
    B, d, f, V = 6, 16, 32, 24
    x = torch.randn(B, d, dtype=torch.float64)
    w1 = torch.randn(d, f, dtype=torch.float64)
    w2 = torch.randn(f, d, dtype=torch.float64)
    logits = torch.randn(B, V, dtype=torch.float64)
    labels = torch.randint(0, V, (B,))
    dy = torch.randn(B, d, dtype=torch.float64)

    def whole():
        xs, a, b, lg = (t.clone().requires_grad_(True)
                        for t in (x, w1, w2, logits))
        y = torch.tanh(xs @ a) @ b
        nll = -torch.log_softmax(lg, -1).gather(-1, labels[:, None])[:, 0]
        (y * dy).sum().backward()
        nll.sum().backward()
        return y, nll, xs.grad, a.grad, b.grad, lg.grad

    def cut(t, dim, g):
        n = t.shape[dim] // g.size
        return t.narrow(dim, g.rank * n, n).contiguous()

    y0, nll0, gx0, ga0, gb0, gl0 = whole()
    xs = x.clone().requires_grad_(True)
    a = cut(w1, 1, model).requires_grad_(True)
    b = cut(w2, 0, model).requires_grad_(True)
    lg = cut(logits, 1, model).requires_grad_(True)
    y = L.row_linear(torch.tanh(collectives.copy_to(xs, model) @ a), b, model)
    nll = collectives.vocab_parallel_nll(lg, labels, model)
    (y * dy).sum().backward()
    nll.sum().backward()
    err = {"y": (y - y0).abs().max().item(),
           "nll": (nll - nll0).abs().max().item(),
           "dx": (xs.grad - gx0).abs().max().item(),
           "dw1": (a.grad - cut(ga0, 1, model)).abs().max().item(),
           "dw2": (b.grad - cut(gb0, 0, model)).abs().max().item(),
           "dlogits": (lg.grad - cut(gl0, 1, model)).abs().max().item()}
    # gather_from: a block gathered, then a computation alike on every rank
    a = cut(w1, 1, model).requires_grad_(True)
    whole_w = collectives.gather_from(a, model, 1)
    (torch.tanh(x @ whole_w) * (x @ w1)).sum().backward()
    w = w1.clone().requires_grad_(True)
    (torch.tanh(x @ w) * (x @ w1)).sum().backward()
    err["gather_from"] = (a.grad - cut(w.grad, 1, model)).abs().max().item()
    # gather_sum: each data rank's rows use the gathered weight
    a = cut(w1, 0, data).requires_grad_(True)
    rows = cut(x, 0, data)
    (torch.tanh(rows @ collectives.gather_sum(a, data, 0)) * cut(
        x @ w1, 0, data)).sum().backward()
    err["gather_sum"] = (a.grad - cut(w.grad, 0, data)).abs().max().item()
    return err


# ----------------------------------------------------------------------------
# The grid train step's rank body
# ----------------------------------------------------------------------------
def train_rank(grid, cases):
    """Each case of ``cases`` whose ``shape`` is this grid's: its train steps
    on this rank, from the case's whole ``params`` (numpy; the JAX
    package's, or None for the port's own seeded init) and, where given,
    its whole AdamW ``state`` (numpy, as ``api.opt_state_from_numpy``
    takes it), over its global ``batches``.  Per step: every rank's metrics
    and leaf shapes, and rank 0's whole params and state (gathered).  A
    case with ``ckpt_save`` saves its final state there (layout-free); one
    with ``ckpt_restore`` first restores its state from there."""
    torch.set_num_threads(1)
    out = {}
    for name, c in cases.items():
        if tuple(c["shape"]) != grid.shape:
            continue
        cfg = port_cfg(c.get("arch", ARCH), **c.get("cfg", {}))
        ocfg = topt.AdamWConfig(**c.get("opt", OPT))
        step = tstep.make_train_step(cfg, ocfg, grid)
        lay = step.layout
        if c.get("params") is None:
            whole = api.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
            params = lay.shard_tree(whole)
        else:
            params = api.train_params_from_numpy(c["params"], lay, "cpu")
        state = topt.init_state(params, ocfg, layout=lay)
        cuts = lay.state_cuts(state)
        if c.get("state") is not None:
            state = lay.shard_tree(api.opt_state_from_numpy(c["state"], "cpu"),
                                   cuts["opt"])
        restored = None
        if c.get("ckpt_restore"):
            got, _ = CheckpointManager(c["ckpt_restore"]).restore(
                {"params": params, "opt": state}, layout=lay, cuts=cuts)
            params, state = got["params"], got["opt"]
            with torch.no_grad():
                full = lay.gather_tree(got, cuts)
            restored = {"shapes": {k: tuple(t.shape)
                                   for k, t in topt.leaves(got)},
                        "state": _numpy(full) if grid.rank == 0 else None}
        hist = []
        for batch in c["batches"]:
            params, state, m = step(params, state, batch)
            rec = {"metrics": {k: float(v) for k, v in m.items()},
                   "shapes": {k: tuple(t.shape)
                              for k, t in topt.leaves(params)}}
            with torch.no_grad():
                full = lay.gather_tree({"params": params, "opt": state}, cuts)
            if grid.rank == 0:
                rec["state"] = _numpy(full)
            hist.append(rec)
        if c.get("ckpt_save"):
            mgr = CheckpointManager(c["ckpt_save"])
            mgr.save(len(c["batches"]) - 1, {"params": params, "opt": state},
                     metadata={"mesh": list(grid.shape)}, layout=lay,
                     cuts=cuts)
            mgr.wait()
        out[name] = {"hist": hist, "restored": restored,
                     "cuts": lay.flat_cuts(),
                     "state_cuts": _state_cuts(lay, state)}
    return out


def _state_cuts(lay, state):
    from repro_torch.distributed.sharding import flat_cuts
    return flat_cuts(lay.state_cuts(state))


def one_device(arch, cfg_kw, opt, batches, params=None, state=None):
    """The port's one-device train steps of the same case: per step the
    metrics and the whole params and state (numpy)."""
    cfg = port_cfg(arch, **cfg_kw)
    ocfg = topt.AdamWConfig(**opt)
    p = (api.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
         if params is None else api.params_from_numpy(params, "cpu"))
    s = (topt.init_state(p, ocfg) if state is None
         else api.opt_state_from_numpy(state, "cpu"))
    step = tstep.make_train_step(cfg, ocfg)
    hist = []
    for batch in batches:
        p, s, m = step(p, s, batch)
        hist.append({"metrics": {k: float(v) for k, v in m.items()},
                     "state": _numpy({"params": p, "opt": s})})
    return hist, p, s


def collectives_grid_rank(grid, params, batch):
    """:func:`collectives_rank` and :func:`functions_rank` in one spawn."""
    return collectives_rank(grid, params, batch), functions_rank(grid)


def card_step_rank(grid, batch):
    """One grid train step of granite-8b reduced (bf16 compute) on this
    rank's card from the port's seeded params (drawn on the card): its
    metrics and kernel launches."""
    from repro_torch.core.device import exact_matmuls
    from repro_torch.kernels import ops
    dev = grid.device
    exact_matmuls()
    cfg = port_cfg()
    ocfg = topt.AdamWConfig(**OPT)
    step = tstep.make_train_step(cfg, ocfg, grid)
    whole = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    with torch.no_grad():
        params = step.layout.shard_tree(whole)
    state = topt.init_state(params, ocfg, layout=step.layout)
    ops.reset_launch_counts()
    params, state, m = step(params, state, batch)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "launches": ops.launch_counts()}


def card_family_step_rank(grid, cases):
    """One grid train step of each case ``name -> (arch, overrides, batch)``
    (bf16 compute, remat "none") on this rank's card from the port's seeded
    params (drawn on the card): its metrics and kernel launches."""
    from repro_torch.core.device import exact_matmuls
    from repro_torch.kernels import ops
    dev = grid.device
    exact_matmuls()
    out = {}
    for name, (arch, over, batch) in cases.items():
        cfg = port_cfg(arch, **over)
        cfg = port_cfg(arch, parallel=dataclasses.replace(
            cfg.parallel, remat="none"), **over)
        ocfg = topt.AdamWConfig(**OPT)
        step = tstep.make_train_step(cfg, ocfg, grid)
        whole = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), device=dev)
        with torch.no_grad():
            params = step.layout.shard_tree(whole)
        state = topt.init_state(params, ocfg, layout=step.layout)
        ops.reset_launch_counts()
        params, state, m = step(params, state, batch)
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "launches": ops.launch_counts()}
    return out
