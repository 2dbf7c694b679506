"""The single-device train step: the JAX package's ``make_train_step``.

The reference jits ``value_and_grad(api.loss_fn)`` and ``apply_updates``
into one program with donated params and optimizer state.  Here the step is
eager: the loss's forward (the flash and scan kernels on the card, through
their autograd Functions), ``torch.autograd.grad`` over every param, and
``optimizer.apply_updates``, which writes the new params and moments into
their tensors in place (the donation).  The reference's other builders
(``make_prefill_step``, ``make_decode_loop``, ``make_slot_step``,
``make_serve_step``) are jit wrappers of work the port's serving engines
do.
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


def make_train_step(cfg: ModelConfig, optcfg: opt.AdamWConfig
                    ) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one AdamW step on the loss of ``batch``, params and state
    updated in place (every param tensor is made to require grad).  The
    metrics are float32 0-d tensors on the params' device: ``loss`` and
    ``aux`` (``api.loss_fn``), ``total`` (the differentiated loss),
    ``grad_norm`` and ``lr``."""

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

