"""The train step: the JAX package's ``make_train_step``, on one device or
on a ``(data, model)`` grid of ranks.

The reference jits ``value_and_grad(api.loss_fn)`` and ``apply_updates``
into one program with donated params and optimizer state.  Here the step is
eager: the loss's forward (the flash and scan kernels on the card, through
their autograd Functions), ``torch.autograd.grad`` over every param, and
``optimizer.apply_updates``, which writes the new params and moments into
their tensors in place (the donation).  The reference's other builders
(``make_prefill_step``, ``make_decode_loop``, ``make_slot_step``,
``make_serve_step``) are jit wrappers of work the port's serving engines
do.

On a grid (``grid=``, a ``distributed/runtime.py::Grid``; every rank runs
the step on its blocks) the params are cut by the reference's
``param_pspecs`` rules (``sharding.train_param_cuts``: FSDP over "data",
Megatron's column and row cuts over "model"), the step takes the global
batch and keeps this data rank's rows, and the loss is the global batch's
(``api.loss_fn(layout=)``).  Gradients: an FSDP-cut leaf's come back
reduce-scattered over "data" from its per-layer gather's backward; every
other leaf's are summed over "data" here (one float32 all-reduce of them
all: each rank's gradient is its rows' part of the global loss's);
model-replicated leaves get the same gradient on every model rank (their
inputs' gradients were all-reduced).  The optimizer then updates each
rank's blocks (``optimizer.apply_updates(layout=)``), so the metrics are
the same on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.train import optimizer as opt


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors (``tokens``, ``labels``, optional
    ``mask`` and ``frontend``) as tensors on ``device``."""
    def conv(v):
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
            v, np.ndarray) else v
        return t.to(device, non_blocking=True)

    return {k: conv(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, optcfg: opt.AdamWConfig,
                    grid=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one AdamW step on the loss of ``batch``, params and state
    updated in place (every param tensor is made to require grad).  The
    metrics are float32 0-d tensors on the params' device: ``loss`` and
    ``aux`` (``api.loss_fn``), ``total`` (the differentiated loss),
    ``grad_norm`` and ``lr``.  ``grid``: this rank's step on its blocks
    (module docstring; ``train_step.layout`` is the grid's
    ``sharding.Layout``)."""
    if grid is not None:
        return _grid_step(cfg, optcfg, grid)

    def train_step(params, opt_state, batch):
        keys, flat = zip(*opt.leaves(params))
        for t in flat:
            t.requires_grad_(True)
        batch = batch_to(batch, flat[0].device)
        total, metrics = api.loss_fn(params, batch, cfg)
        grads = opt.rebuild(params, dict(zip(
            keys, torch.autograd.grad(total, flat))))
        params, opt_state, om = opt.apply_updates(params, grads, opt_state,
                                                  optcfg)
        metrics = {k: v.detach() for k, v in
                   dict(metrics, **om, total=total).items()}
        return params, opt_state, metrics

    return train_step



def _grid_step(cfg: ModelConfig, optcfg: opt.AdamWConfig, grid) -> Callable:
    layout = api.train_layout(cfg, grid)
    cuts = layout.flat_cuts()
    data = grid.data

    def train_step(params, opt_state, batch):
        keys, flat = zip(*opt.leaves(params))
        for t in flat:
            t.requires_grad_(True)
        batch = batch_to(layout.batch_rows(batch), flat[0].device)
        total, metrics = api.loss_fn(params, batch, cfg, layout=layout)
        grads = dict(zip(keys, torch.autograd.grad(total, flat)))
        # the leaves without a data cut: one float32 sum over "data"
        summed = [k for k in keys if cuts[k][1] is None]
        if data.size > 1 and summed:
            buf = data.all_reduce(torch.cat([
                grads[k].to(torch.float32).reshape(-1) for k in summed]))
            for k, part in zip(summed, torch.split(
                    buf, [grads[k].numel() for k in summed])):
                grads[k] = part.reshape(grads[k].shape).to(grads[k].dtype)
        params, opt_state, om = opt.apply_updates(
            params, opt.rebuild(params, grads), opt_state, optcfg,
            layout=layout)
        metrics = {k: v.detach() for k, v in
                   dict(metrics, **om, total=total).items()}
        return params, opt_state, metrics

    train_step.layout = layout
    return train_step
