"""The Split-Brain protocol (§IV-B, §VI-C): partition + traffic/latency model.

Two halves:
  * ``TrafficModel`` — the analytical bandwidth/latency model reproducing
    eq. 7-11 and Table III for any architecture config (not just Llama-2-7B).
  * ``TrafficMeter`` — runtime byte accounting used by the serving engine:
    every tensor that crosses the host<->device boundary is registered, so
    the *measured* per-token traffic can be checked against the analytical
    model (they must agree exactly — that is a test).

The device side is stateless (hardwired linear maps); the host side owns all
dynamic state (KV cache / SSM state), attention, normalization statistics,
and sampling.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

__all__ = ["Interface", "INTERFACES", "TrafficModel", "TrafficMeter"]

ACT_BYTES = 2  # INT16 activations on the wire (§VI-C.1)
DEVICE_COMPUTE_S = 64e-6      # 64 us linear-projection latency (§VI-C.2)
HOST_ATTENTION_S = 5e-3       # 5 ms host attention (NPU-offload scenario)
HOST_ATTENTION_CPU_S = 75e-3  # 50-100 ms realistic CPU scenario midpoint


@dataclass(frozen=True)
class Interface:
    name: str
    gbps: float                # marketing line rate
    effective_bytes_per_s: float  # sustained payload bandwidth used by the paper
    extra_cost_usd: float


INTERFACES: Dict[str, Interface] = {
    "pcie3x4": Interface("PCIe 3.0 x4", 32, 4e9, 15.0),
    "tb4": Interface("Thunderbolt 4", 40, 5e9, 30.0),
    "usb3": Interface("USB 3.0", 5, 300e6, 5.0),
    "usb4": Interface("USB 4.0", 40, 2e9, 10.0),
}


@dataclass(frozen=True)
class TrafficModel:
    """Per-token host<->device traffic for a decoder layer stack.

    Parameters describe the *backbone* that is split-brain partitioned.
    ``recurrent_state_dim`` covers attention-free blocks (RWKV/SSM): the
    recurrent update runs on the host, so the device ships the projected
    r/k/v/g vectors instead of K/V — same accounting, different width.
    """

    num_layers: int
    d_model: int
    kv_dim: int              # kv_heads * head_dim (= d_model for MHA)
    vocab_size: int
    act_bytes: int = ACT_BYTES
    cross_attn_layers: int = 0   # extra layers shipping cross-attn K/V (VLM/enc-dec)
    cross_kv_dim: int = 0
    recurrent_state_dim: int = 0  # extra per-layer host-bound projections (SSM/RWKV)

    # ---- eq. 7-9 ----
    def device_to_host_kv_bytes_per_layer(self) -> int:
        return 2 * self.kv_dim * self.act_bytes  # K and V projections

    def host_to_device_attn_bytes_per_layer(self) -> int:
        return self.d_model * self.act_bytes     # attention output

    def logits_bytes(self) -> int:
        return self.vocab_size * self.act_bytes

    # ---- eq. 10 ----
    def bytes_per_token(self) -> int:
        per_layer = (self.device_to_host_kv_bytes_per_layer()
                     + self.host_to_device_attn_bytes_per_layer()
                     + 2 * self.recurrent_state_dim * self.act_bytes)
        cross = self.cross_attn_layers * 2 * self.cross_kv_dim * self.act_bytes
        # cross-attn K/V are per-request (prefill), amortized ~0 per decode
        # token; counted separately via prefill_bytes().
        del cross
        return per_layer * self.num_layers + self.logits_bytes()

    def prefill_bytes(self, prompt_tokens: int, image_or_enc_tokens: int = 0) -> int:
        per_tok_body = self.bytes_per_token() - self.logits_bytes()
        cross = (self.cross_attn_layers * 2 * self.cross_kv_dim * self.act_bytes
                 * image_or_enc_tokens)
        return per_tok_body * prompt_tokens + self.logits_bytes() + cross

    # ---- eq. 11 ----
    def bandwidth_bytes_per_s(self, tokens_per_s: float = 20.0) -> float:
        return self.bytes_per_token() * tokens_per_s

    # ---- Table III ----
    def interface_latency(self, iface: Interface, host_attention_s: float = HOST_ATTENTION_S) -> Dict[str, float]:
        transfer_s = self.bytes_per_token() / iface.effective_bytes_per_s
        total_s = transfer_s + DEVICE_COMPUTE_S + host_attention_s
        return {
            "interface": iface.name,
            "transfer_ms": transfer_s * 1e3,
            "total_ms": total_s * 1e3,
            "tokens_per_s": 1.0 / total_s,
            "extra_cost_usd": iface.extra_cost_usd,
        }

    def interface_table(self) -> List[Dict[str, float]]:
        return [self.interface_latency(i) for i in INTERFACES.values()]

    @staticmethod
    def llama2_7b() -> "TrafficModel":
        """The paper's reference config (32L, d=4096, MHA, 32K vocab)."""
        return TrafficModel(num_layers=32, d_model=4096, kv_dim=4096, vocab_size=32000)

    @classmethod
    def for_config(cls, cfg) -> "TrafficModel":
        """Traffic model for any backbone config (eq. 7-10 abstraction).

        ``kv_dim`` is the per-layer dynamic-state projection width the device
        ships to the host each token: K/V for attention families, the
        K/V-equivalent recurrence inputs for attention-free blocks (both are
        ``num_kv_heads * head_dim`` wide in our configs).  This is the single
        accounting rule the serving engines and the continuous-batching
        scheduler replay per *active* token (DESIGN.md §4).
        """
        return cls(num_layers=cfg.num_layers, d_model=cfg.d_model,
                   kv_dim=cfg.kv_dim, vocab_size=cfg.vocab_size)


class TrafficMeter:
    """Runtime byte counter for tensors crossing the host/device boundary.

    A third, separately-tracked channel — ``host_read`` — counts HOST-LOCAL
    memory reads that never cross the interface (the KV-cache bytes host
    attention touches per decode step).  Like the rest of the meter these
    are replayed accounting entries, not hardware counters: each serve
    discipline logs its read MODEL (see
    ``serve/pages.py::PagedEngineMixin.kv_read_bytes_step``).  Eq. 7-10 do
    not include them, so they are excluded from :meth:`measured_bytes` and
    the exactness assertions; they exist so the paged serve path can report
    that its kernel reads only LIVE-page KV bytes per token, where the
    gather (dense-view) discipline reads ``max_slots x max_len`` worth
    regardless of occupancy.
    """

    def __init__(self) -> None:
        self.device_to_host = 0
        self.host_to_device = 0
        self.host_read_bytes = 0
        self.log: List[Tuple[str, str, int]] = []
        self.host_log: List[Tuple[str, int]] = []

    @staticmethod
    def _nbytes(shape, act_bytes: int = ACT_BYTES) -> int:
        return int(math.prod(shape)) * act_bytes

    def d2h(self, name: str, shape, act_bytes: int = ACT_BYTES) -> None:
        n = self._nbytes(shape, act_bytes)
        self.device_to_host += n
        self.log.append(("d2h", name, n))

    def h2d(self, name: str, shape, act_bytes: int = ACT_BYTES) -> None:
        n = self._nbytes(shape, act_bytes)
        self.host_to_device += n
        self.log.append(("h2d", name, n))

    def host_read(self, name: str, nbytes: int) -> None:
        """Log host-local bytes read (no boundary crossing; see class doc).
        Takes a byte count directly — these are real cache-dtype bytes, not
        eq. 7-10 wire widths."""
        n = int(nbytes)
        self.host_read_bytes += n
        self.host_log.append((name, n))

    def host_channel_bytes(self, name: str) -> int:
        """Total host-local bytes logged under ONE channel name.  The host
        channels are heterogeneous (KV reads, prefix-cache savings, CoW
        copies), so consumers comparing a specific quantity must filter by
        channel instead of using the ``host_read_bytes`` aggregate."""
        return sum(n for ch, n in self.host_log if ch == name)

    @property
    def total(self) -> int:
        return self.device_to_host + self.host_to_device

    def measured_bytes(self, count_q: bool = False) -> Dict[str, int]:
        """Summed boundary bytes under the paper's accounting.

        Eq. 7-10 count K/V out, attention in, logits out; the engines
        additionally log the QKV input activation under the name
        ``x_qkv_in``, which ``count_q=False`` (the paper's rule) excludes.
        The single accounting filter both serving engines share.
        """
        d2h = h2d = 0
        for direction, name, nbytes in self.log:
            if not count_q and name == "x_qkv_in":
                continue
            if direction == "d2h":
                d2h += nbytes
            else:
                h2d += nbytes
        return {"d2h": d2h, "h2d": h2d, "total": d2h + h2d}

    def reset(self) -> None:
        self.device_to_host = 0
        self.host_to_device = 0
        self.host_read_bytes = 0
        self.log.clear()
        self.host_log.clear()
