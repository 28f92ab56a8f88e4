"""Frozen formulas of work: the model flops of a token, a prefill and a
train step, the least work of the prefill attention, and the device's
peaks. Copied from the port's arithmetic (``configs/base.py``'s parameter
count, ``kernels/flash_attention.py``'s ``flash_attention_cost`` at the
causal triangle) and frozen here, so a change to the program cannot move
the yardstick."""
from __future__ import annotations

from typing import Dict, Tuple

#: NVIDIA's data sheet of the H100 SXM, dense rates at the 700 W limit
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def _hd(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def layer_params(m: Dict, active: bool) -> int:
    """A decoder layer's weight parameters (norm gains left out); ``active``
    counts a MoE layer's routed experts at ``experts_per_token``."""
    d, hd = m["d_model"], _hd(m)
    attn = d * m["n_heads"] * hd * 2 + 2 * d * m["n_kv_heads"] * hd
    ffn = 3 * d * m["d_ff"]
    if m["family"] == "moe":
        n = m["experts_per_token"] if active else m["n_experts"]
        return attn + n * ffn + d * m["n_experts"]
    return attn + ffn


def matmul_params(m: Dict, active: bool = True) -> int:
    """Parameters that take part in a token's products: the layers and the
    output head, not the embedding lookup."""
    return (m["n_layers"] * layer_params(m, active)
            + m["d_model"] * m["vocab_size"])


def attn_entry_flops(m: Dict) -> int:
    """Flops of one score entry over all q heads: ``2 (D + Dv) H``."""
    return 2 * 2 * _hd(m) * m["n_heads"]


def decode_token_flops(m: Dict, keys: int) -> float:
    """A decoded token that attends ``keys`` positions."""
    return (2.0 * matmul_params(m)
            + m["n_layers"] * attn_entry_flops(m) * keys)


def prefill_flops(m: Dict, length: int) -> float:
    """A prompt of ``length`` true tokens, causal."""
    tri = length * (length + 1) / 2
    return (2.0 * matmul_params(m) * length
            + m["n_layers"] * attn_entry_flops(m) * tri)


def train_step_flops(m: Dict, batch: int, seq: int) -> float:
    """6 x parameters x tokens plus 3 x the causal attention's forward."""
    tri = seq * (seq + 1) / 2
    return (6.0 * matmul_params(m) * batch * seq
            + 3.0 * batch * m["n_layers"] * attn_entry_flops(m) * tri)


def prefill_attention_need(m: Dict, length: int, itemsize: int
                           ) -> Tuple[float, float]:
    """(flops, bytes) the prefill attention of one prompt needs over all
    layers: the causal triangle at ``2 (D + Dv)`` flops an entry; q, k, v
    and o each read or written once."""
    hd, H, Hkv = _hd(m), m["n_heads"], m["n_kv_heads"]
    tri = length * (length + 1) / 2
    flops = m["n_layers"] * attn_entry_flops(m) * tri
    byts = m["n_layers"] * itemsize * length * (2 * H * hd + 2 * Hkv * hd)
    return flops, float(byts)


def least_seconds(flops: float, byts: float) -> float:
    return max(flops / PEAKS["bf16_flops"], byts / PEAKS["hbm_bytes_per_s"])
