"""GPipe-style pipeline parallelism: the JAX package's
``distributed/pipeline.py``, one process per stage.

The layer stack is split into ``S`` stages over the ranks of a ``"pipe"``
group (rank *s* holds stage *s*'s params); a microbatched schedule streams
activations stage to stage.  Running ``M + S - 1`` ticks drains the pipe;
the bubble fraction is ``(S - 1) / (M + S - 1)``.

Each tick is the reference's ``shard_map`` body: stage 0 injects
microbatch ``min(t, M - 1)``, every stage applies its ``stage_fn``, stage
``S - 1`` collects its result into slot ``t - (S - 1)`` once ``t >= S -
1``, and the state shifts one rank up (the reference's ``ppermute`` ``i ->
i + 1 mod S``).  The shift is an all-gather of the ranks' states, of which
each rank keeps its predecessor's: gloo's ``send`` / ``recv`` of CUDA
tensors is not relied on.  Every stage computes in every tick, the bubble's
ticks on a zero or stale state, as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.runtime import TPGroup


def pipeline_apply(group: TPGroup, stage_fn: Callable,
                   num_microbatches: int) -> Callable:
    """Build a pipelined apply: ``y = stage_{S-1}(... stage_0(x))``.

    ``stage_fn(stage_params, x_mb) -> y_mb`` applies ONE stage to ONE
    microbatch (same activation shape in and out).  The returned callable
    takes this rank's ``stage_params`` and ``x`` (M, mb, ...) (the same on
    every rank) and returns the last stage's ``y`` (M, mb, ...), the same
    on every rank."""
    S = group.size
    M = num_microbatches
    idx = group.rank

    def apply(stage_params, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != M:
            raise ValueError(f"x has {x.shape[0]} microbatches, not {M}")
        state = torch.zeros_like(x[0])
        outputs = torch.zeros_like(x)
        for t in range(M + S - 1):
            if idx == 0:
                state = x[min(t, M - 1)]
            state = stage_fn(stage_params, state)
            if idx == S - 1 and t >= S - 1:
                outputs[t - (S - 1)] = state
            state = group.all_gather(state)[(idx - 1) % S]
        return group.all_gather(outputs)[S - 1]

    return apply


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
