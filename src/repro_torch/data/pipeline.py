"""Deterministic, shard-aware synthetic data pipeline (pure numpy).

A copy of the JAX package's ``data/pipeline.py``: batches come from a
counter-based PRNG keyed by (seed, step, shard), so

  * every restart resumes exactly (the step index is the only state),
  * every data-parallel shard draws a disjoint, reproducible stream,
  * elastic re-sharding (a change of data-parallel size) re-partitions the
    same global stream: batch ``step`` is identical however many hosts
    read it.

The stream is a mixture of Zipf-distributed tokens and copy runs, so that
models have learnable structure and the loss falls in a short run.  The
batches are numpy arrays, bit-identical to the JAX package's for every
``(seed, step, shard, num_shards)``, frontend included; the train step
moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    copy_prob: float = 0.3      # fraction of positions inside copy runs
    frontend_tokens: int = 0
    d_model: int = 0


def _batch_rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def global_batch_at_step(cfg: DataConfig, step: int,
                         shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
    """The (deterministic) shard-local slice of global batch ``step``."""
    assert cfg.global_batch % num_shards == 0
    per = cfg.global_batch // num_shards
    rng = _batch_rng(cfg, step, 0)  # one global stream...
    toks = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len + 1))
    toks = np.minimum(toks, cfg.vocab_size - 1).astype(np.int32)
    # copy runs: the second half of each row repeats the first with p
    half = (cfg.seq_len + 1) // 2
    copy_mask = rng.random((cfg.global_batch, half)) < cfg.copy_prob
    toks[:, half:half * 2][copy_mask] = toks[:, :half][copy_mask]
    sl = slice(shard * per, (shard + 1) * per)  # ...sliced per shard
    out = {
        "tokens": toks[sl, :-1],
        "labels": toks[sl, 1:],
    }
    if cfg.frontend_tokens:
        out["frontend"] = rng.standard_normal(
            (cfg.global_batch, cfg.frontend_tokens, cfg.d_model)
        ).astype(np.float32)[sl]
    return out


class DataLoader:
    """Stateful iterator facade; state == step index (checkpointable)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.step = start_step
        self.shard = shard
        self.num_shards = num_shards

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = global_batch_at_step(self.cfg, self.step, self.shard, self.num_shards)
        self.step += 1
        return b

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, s: Dict[str, int]) -> None:
        self.step = int(s["step"])
