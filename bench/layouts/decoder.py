"""The parameter tree of the port's dense and MoE decoders (GQA attention),
written down from the configuration alone (``bench/configs/*.json`` with
``"layout": "bench/layouts/decoder.py"``): each leaf's path, shape and how
it is drawn (:mod:`bench.core.weights`).

Scales: a matrix ``N(0, 1 / fan_in)`` (its fan-in the input width its
product contracts), so activations keep unit size through every product;
the embedding ``N(0, 1)``; each norm's gain ``1 + N(0, 0.1^2)``, so a norm
that drops its gain shows.
"""
from __future__ import annotations

from typing import Dict, List

from bench.core.weights import Leaf

GAIN_SCALE = 0.1


def padded_vocab(m: Dict) -> int:
    mult = m.get("pad_vocab_multiple", 256)
    return -(-m["vocab_size"] // mult) * mult


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def layout(m: Dict) -> List[Leaf]:
    """Every leaf of a dense or MoE decoder, in the port's tree order:
    ``emb``, ``ln_f``, ``unemb`` (untied), then each layer's ``ln1``,
    ``ln2``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``} and ``mlp``
    ({``wi``, ``wg``, ``wo``}, or the MoE's {``router``, ``experts``
    {``wi``, ``wg``, ``wo``}})."""
    if m["family"] not in ("dense", "moe") or m.get("qkv_bias"):
        raise ValueError(f"no weight layout for family {m['family']!r} "
                         f"with qkv_bias={m.get('qkv_bias')}")
    d, V = m["d_model"], padded_vocab(m)
    H, Hkv, hd, ff = m["n_heads"], m["n_kv_heads"], head_dim(m), m["d_ff"]
    out: List[Leaf] = [("emb", (V, d), "normal", 1.0),
                       ("ln_f", (d,), "gain", GAIN_SCALE)]
    if not m.get("tie_embeddings"):
        out.append(("unemb", (d, V), "normal", d ** -0.5))
    for i in range(m["n_layers"]):
        p = f"layers/{i}"
        out += [(f"{p}/ln1", (d,), "gain", GAIN_SCALE),
                (f"{p}/ln2", (d,), "gain", GAIN_SCALE),
                (f"{p}/attn/wq", (d, H, hd), "normal", d ** -0.5),
                (f"{p}/attn/wk", (d, Hkv, hd), "normal", d ** -0.5),
                (f"{p}/attn/wv", (d, Hkv, hd), "normal", d ** -0.5),
                (f"{p}/attn/wo", (H, hd, d), "normal", (H * hd) ** -0.5)]
        if m["family"] == "moe":
            E = m["n_experts"]
            out += [(f"{p}/mlp/router", (d, E), "normal", d ** -0.5),
                    (f"{p}/mlp/experts/wi", (E, d, ff), "normal", d ** -0.5),
                    (f"{p}/mlp/experts/wg", (E, d, ff), "normal", d ** -0.5),
                    (f"{p}/mlp/experts/wo", (E, ff, d), "normal", ff ** -0.5)]
        else:
            out += [(f"{p}/mlp/wi", (d, ff), "normal", d ** -0.5),
                    (f"{p}/mlp/wg", (d, ff), "normal", d ** -0.5),
                    (f"{p}/mlp/wo", (ff, d), "normal", ff ** -0.5)]
    return out
