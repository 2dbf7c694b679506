"""AdamW with optional int8 blockwise moments, in PyTorch.

The JAX package's ``train/optimizer.py``, held to its jitted
``apply_updates`` (``make_train_step`` jits it): on the CPU the new params,
``m``, ``v`` and ``lr`` are bit-identical over several steps, and with
``quantize_moments`` so are the int8 codes and scales.  What that takes:

* The schedule and the bias corrections are float32 arithmetic in the
  reference (``step`` is an int32 array).  They are computed here on the
  host in numpy float32, op for op in the form XLA compiles them to
  (reciprocal products for the divisions by constants, ``(m / bc1) /
  (sqrt(v / bc2) + eps)`` as ``m / (bc1 (sqrt(v / bc2) + eps))``), with
  ``cos`` and ``pow`` in float64 rounded once to float32.  XLA's CPU
  ``cos`` is not correctly rounded: ``lr`` is one float32 ulp off where it
  differs (about 2 % of the arguments); its ``pow`` differs from the
  rounded value only where ``1 - b ** t`` rounds alike.
* ``_global_norm`` sums the per-leaf sums of squares in ``jax.tree``
  flatten order, which sorts dict keys (:func:`leaves`); each leaf's sum
  is torch's, so the norm may differ from XLA's in its last bit.
* Weight decay applies only to leaves with ``ndim >= 2``.

State layout mirrors the params: ``{"step": int32 0-d tensor, "m": tree,
"v": tree}``, a moment a float32 tensor or a :class:`QMoment` ``(q int8
(blocks, block), scale float32 (blocks, 1))``.  ``apply_updates`` writes
the new values into the param and moment tensors IN PLACE (the reference
donates them to its jitted step).

On a training grid (``layout=``, ``distributed/sharding.py::Layout``) the
params and gradients are a rank's blocks.  The update is elementwise, so a
float32 moment is the block of its param; the global norm sums each
element's square once over the grid (each rank the leaves it owns,
``Layout.owns``, then one all-reduce).  An int8 moment's blocks of 256 run
over the WHOLE flattened leaf, which a rank's block does not tile, so int8
moments are held whole on every rank and updated on the gathered leaf: the
rank gathers the leaf's gradient, every rank computes the same new codes
and scales, and takes its block of the update -- the reference's block
layout, bit for bit, at the cost of one gather of each gradient.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

_F32 = np.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    quantize_moments: bool = False   # int8 blockwise moment storage
    moment_block: int = 256


class QMoment(NamedTuple):
    """An int8 blockwise moment: codes (blocks, block) and per-block float32
    scales (blocks, 1) (the reference's ``_QMoment``)."""
    q: torch.Tensor
    scale: torch.Tensor


# ----------------------------------------------------------------------------
# Trees in the JAX package's flatten order
# ----------------------------------------------------------------------------
def leaves(tree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree`` flatten order: dict keys
    sorted, lists and tuples in order, a :class:`QMoment` as its ``.q`` and
    ``.scale`` (the JAX package's path strings, ``ckpt/manager.py``).  A
    leaf is anything else (a tensor)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, QMoment):
            walk(node.q, path + (".q",))
            walk(node.scale, path + (".scale",))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    walk(tree, ())
    return out


def rebuild(like, values: Dict[str, Any]):
    """``like``'s structure with each leaf replaced by ``values[path]``
    (paths as :func:`leaves` gives them)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, QMoment):
            return QMoment(walk(node.q, path + (".q",)),
                           walk(node.scale, path + (".scale",)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        return values["/".join(path)]

    return walk(like, ())


def map_params(fn, params):
    """``fn`` applied to every tensor of ``params`` (dicts and lists), the
    structure kept."""
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(map_params(fn, v) for v in params)
    return fn(params)


# ----------------------------------------------------------------------------
# Schedule (host float32 scalars)
# ----------------------------------------------------------------------------
def lr_schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """Linear warmup + cosine decay to ``min_lr_frac``: the reference's
    float32 expression at int32 ``step``, as a numpy float32, in the form
    XLA compiles it to: the divisions by the constant spans are products
    by their float32 reciprocals; ``0.5 (1 + cos)`` times ``1 -
    min_lr_frac`` is ``(1 + cos)`` times their float32 product (exact, the
    0.5 being a power of two)."""
    s = _F32(step)
    warm = min(_F32(s + _F32(1)) * _recip(max(1, cfg.warmup_steps)),
               _F32(1.0))
    prog = _F32(s - _F32(cfg.warmup_steps)) * _recip(
        max(1, cfg.total_steps - cfg.warmup_steps))
    prog = min(_F32(1.0), max(_F32(0.0), prog))
    cos = _F32(math.cos(float(prog * _F32(math.pi))))
    frac = _F32((_F32(1) + cos) * _F32(_F32(0.5) * _F32(1 - cfg.min_lr_frac))
                ) + _F32(cfg.min_lr_frac)
    return _F32(warm * _F32(cfg.lr)) * frac


def _recip(n: int) -> np.float32:
    return _F32(1) / _F32(n)


def _bias_correction(b: float, t: np.float32) -> np.float32:
    return _F32(1) - _F32(math.pow(float(_F32(b)), float(t)))


# ----------------------------------------------------------------------------
# int8 blockwise moment codec
# ----------------------------------------------------------------------------
def q8(x: torch.Tensor, block: int) -> QMoment:
    """float32 ``x`` -> int8 codes (blocks, block) and float32 scales
    (blocks, 1): ``scale = max(amax * (1/127), 1e-20)`` per block (XLA
    turns the division by the constant into that product), ``q =
    clip(round(x / scale), -127, 127)`` with round half to even."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) * _F32(1.0 / 127.0)
    scale = torch.clamp_min(scale, 1e-20)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return QMoment(q, scale.to(torch.float32))


def dq8(m: QMoment, shape, size: int) -> torch.Tensor:
    return (m.q.to(torch.float32) * m.scale).reshape(-1)[:size].reshape(shape)


def init_state(params, cfg: AdamWConfig, layout=None) -> Dict[str, Any]:
    """Zero moments (int8 codes and 1e-20 scales with
    ``quantize_moments``) on each param's device, and step 0.  ``layout``:
    ``params`` are a grid rank's blocks, and an int8 moment is the whole
    leaf's (module docstring)."""
    keys = {id(t): k for k, t in leaves(params)}

    def zeros(p):
        shape = p.shape
        if layout is not None and cfg.quantize_moments:
            shape = layout.shapes[keys[id(p)]]
        z = torch.zeros(shape, dtype=torch.float32, device=p.device)
        return q8(z, cfg.moment_block) if cfg.quantize_moments else z

    device = next(t for _, t in leaves(params)).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": map_params(zeros, params),
            "v": map_params(zeros, params)}


def global_norm(grads, layout=None) -> torch.Tensor:
    """sqrt of the sum of the per-leaf float32 sums of squares, the leaves
    in flatten order (sorted dict keys).  ``layout``: a grid rank's blocks;
    each rank adds the leaves it owns and the sum is all-reduced."""
    if layout is None:
        sums = [torch.sum(torch.square(g.to(torch.float32)))
                for _, g in leaves(grads)]
        return torch.sqrt(torch.sum(torch.stack(sums)))
    cuts = layout.flat_cuts()
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            * (1.0 if layout.owns(cuts[k]) else 0.0)
            for k, g in leaves(grads)]
    return torch.sqrt(layout.grid.world.all_reduce(torch.sum(torch.stack(
        sums))))


# ----------------------------------------------------------------------------
# The update
# ----------------------------------------------------------------------------
@torch.no_grad()
def apply_updates(params, grads, state: Dict[str, Any], cfg: AdamWConfig,
                  layout=None):
    """One AdamW step, in place: the params' and moments' tensors take the
    new values and ``state["step"]`` advances.  Returns (params, state,
    {"grad_norm", "lr"}), the metrics float32 0-d tensors on the params'
    device.  Reads ``state["step"]`` to the host once (the schedule is host
    arithmetic).  ``layout``: a grid rank's blocks (module docstring)."""
    step = int(state["step"])
    gnorm = global_norm(grads, layout)
    cuts = None if layout is None else layout.flat_cuts()
    clip = torch.clamp_max(
        cfg.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    lr = lr_schedule(cfg, step)
    t = _F32(step + 1)
    bc1 = _bias_correction(cfg.b1, t)
    bc2 = _bias_correction(cfg.b2, t)
    # float32 values as Python floats (exact), so torch applies them as
    # float32 scalars
    b1, b2, c1, c2, eps = (float(_F32(c)) for c in (
        cfg.b1, cfg.b2, 1 - cfg.b1, 1 - cfg.b2, cfg.eps))
    bc1, bc2, lr_f = float(bc1), float(bc2), float(lr)

    ps, gs = dict(leaves(params)), dict(leaves(grads))
    for key, p in ps.items():
        g = gs[key].to(torch.float32) * clip
        m, v = _get(state["m"], key), _get(state["v"], key)
        whole = p
        if layout is not None and cfg.quantize_moments:
            g = layout.gather_whole(g, cuts[key])
            whole = g
        # the compiled program fuses one product of each moment's sum into
        # a fused multiply-add (addcmul on the CPU and the card): the
        # moment's for float32 moments; for int8 moments the product it
        # fuses varies with the leaf's shape and padding, and the port
        # takes the gradient's, its most frequent choice
        if cfg.quantize_moments:
            m_f = torch.addcmul(b1 * dq8(m, whole.shape, whole.numel()), g,
                                _scalar(c1, g))
            v_f = torch.addcmul(b2 * dq8(v, whole.shape, whole.numel()),
                                c2 * g, g)
        else:
            m_f = torch.addcmul(c1 * g, m, _scalar(b1, g))
            v_f = torch.addcmul(c2 * g * g, v, _scalar(b2, g))
        # (m / bc1) / (sqrt(v / bc2) + eps), which XLA compiles to one
        # division by a product
        delta = m_f / (bc1 * (_sqrt(v_f / bc2) + eps))
        if whole is not p:
            delta = layout.block(delta, cuts[key])
        decay = _F32(cfg.weight_decay) if p.dim() >= 2 else _F32(0.0)
        keep = _scalar(_F32(1) - lr * decay, g)
        new_p = torch.addcmul(-(lr_f * delta), p.to(torch.float32), keep)
        p.copy_(new_p.to(p.dtype))
        if cfg.quantize_moments:
            for old, new in ((m, q8(m_f, cfg.moment_block)),
                             (v, q8(v_f, cfg.moment_block))):
                old.q.copy_(new.q)
                old.scale.copy_(new.scale)
        else:
            m.copy_(m_f)
            v.copy_(v_f)
    state["step"] += 1
    lr_t = torch.tensor(lr, dtype=torch.float32, device=gnorm.device)
    return params, state, {"grad_norm": gnorm, "lr": lr_t}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as XLA's.  ``torch.sqrt`` is so on the
    card (IEEE ``sqrtf``; ``chip_smoke.py`` checks it), but an ulp off on
    some float32 inputs on the CPU, which goes through float64 (exact after
    the second rounding)."""
    if build.on_card(x):
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _get(tree, key: str):
    for k in key.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree
