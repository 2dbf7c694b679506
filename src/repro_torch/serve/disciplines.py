"""The serve-discipline registry, a copy of the JAX package's
``serve/disciplines.py``: one list of the serving disciplines with a
one-line description and the headline gate of each.

``python -m repro_torch.serve.disciplines`` prints the markdown table
(:func:`markdown_table`); a test holds the tuple and the table equal to
the JAX package's.  The port serves every one of them: ``sequential``
(``generate()``), ``continuous``, ``paged_gather``, ``paged``, ``prefix``,
``overload`` (priorities, deadlines, preemption), ``tp`` (tensor-parallel
serving over ``torch.distributed`` ranks, ``distributed/``), ``chaos``
(fault injection and recovery) and ``kv_quant``.  The ``tp`` entry's text
is the JAX package's: the port's split-brain engine takes the same
column-only cut as the float engine instead of the Megatron row cuts it
names (``distributed/sharding.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Discipline:
    name: str          # registry key; also the serve_bench report section
    title: str         # one-line README description
    gate: str          # the headline gate serve_bench enforces


DISCIPLINES: Tuple[Discipline, ...] = (
    Discipline(
        "sequential",
        "one request at a time, fused prefill + one-dispatch decode loop",
        "baseline (the other disciplines gate against it)"),
    Discipline(
        "continuous",
        "slot-based continuous batching over a dense `(max_slots, …)` cache",
        "requests/s >= 2x sequential; zero steady-state recompiles"),
    Discipline(
        "paged_gather",
        "shared page pool; decode gathers the dense view through the page "
        "table (reference/oracle)",
        "token identity; nonzero dense-view transient (the copy it models)"),
    Discipline(
        "paged",
        "gather-free: attention walks `pool[table]` page-block-wise "
        "(flash-decode Pallas kernel + jnp oracle), zero dense-view "
        "transient",
        ">= 2x dense memory saving; >= gather tokens/s; zero transient "
        "bytes"),
    Discipline(
        "prefix",
        "`paged` + shared-prefix KV reuse: ref-counted CoW pages behind a "
        "radix block-hash index; shared prompt prefixes are mapped, not "
        "re-prefilled",
        "token identity; prefill tokens/s uplift >= 1.3x at >= 50% "
        "overlap; fewer pages stored"),
    Discipline(
        "overload",
        "open-loop arrivals at 2x the service rate with priorities, "
        "deadlines and SLA preemption",
        "high-priority p95 TTFT <= 1.5x unloaded; cancel frees pages in "
        "one iteration"),
    Discipline(
        "tp",
        "tensor-parallel serving (DESIGN.md §11): the same persistent "
        "decode step over a `(\"data\",\"model\")` mesh — float params "
        "column-cut with all-gathers before down-projections (bitwise "
        "token identity; quantized split-brain keeps the full Megatron "
        "cut, int32-exact), page pool cut on KV heads, page tables "
        "host-owned and replicated",
        "token identity tp=2 vs tp=1; per-shard traffic sums byte-exactly; "
        "decode tokens/s >= 1.6x on >= 2 cores"),
    Discipline(
        "chaos",
        "crash-tolerant serving (DESIGN.md §12): seeded step errors, "
        "per-slot NaN logit corruption and wholesale device loss injected "
        "into the paged + prefix engine; the scheduler quarantines "
        "poisoned slots and rebuilds device state from the "
        "host-authoritative copy",
        "token identity vs the uninterrupted run; pool occupancy back to "
        "baseline; recovery time bounded; zero recompiles on a repeat "
        "chaos cycle"),
    Discipline(
        "kv_quant",
        "`paged` over an int8 page pool (DESIGN.md §13): 1-byte codes + "
        "per-page, per-kv-head scales beside the page table, quantized on "
        "write, dequantized inside the flash-decode page fetch",
        ">= 1.8x resident tokens at fixed pool bytes; bounded per-step "
        "greedy argmax flip rate vs bf16; non-KV traffic channels "
        "byte-exact; zero steady-state recompiles"),
)

NAMES: Tuple[str, ...] = tuple(d.name for d in DISCIPLINES)


def markdown_table() -> str:
    """The README's discipline table, generated (do not hand-edit the
    README copy — regenerate with ``python -m repro_torch.serve.disciplines``)."""
    lines = ["| discipline | what it is |", "|---|---|"]
    lines += [f"| `{d.name}` | {d.title} |" for d in DISCIPLINES]
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown_table())
