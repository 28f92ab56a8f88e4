"""The one traffic generator: it reads a mix's parameters from
``bench/traffic/<mix>.json`` and makes the cell's inputs from ``--seed``.

Every seed gets the same work: each block of ``block`` requests holds the
same ``block`` prompt lengths (the distribution's quantiles at ``(j + 0.5)
/ block``), paired once and for all with the same ``block`` output lengths,
in an order shuffled within each block by a fixed stream, so every seed
serves the same schedule of sizes; the seed draws the token ids. A serving
mix may start warm
(``"warm_start": "residual_life"``): its first ``clients`` requests, which
fill the pool before the window, keep only a residual of their output,
drawn as a stationary closed loop's would be (a length picked in proportion
to itself, then a uniform point of it), so the window opens on a pool whose
slots are staggered.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

#: the fixed stream of the pairing of prompt and output quantiles, of the
#: order of the sizes and of the warm start's residuals
_PAIRING_SEED = 20240531


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """numpy's generator for ``seed`` (any whole number) and a stream."""
    return np.random.default_rng([int(seed) % (2 ** 64), stream])


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """``n`` whole lengths at the quantiles ``(j + 0.5) / n`` of ``spec``
    (``lognormal``: ``median``, ``sigma``; ``uniform``: ``min`` to
    ``max``), clipped to ``[min, max]``."""
    p = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(q)) for q in p])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        x = lo + (hi - lo) * p
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def block_pairs(t: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """The ``block`` (prompt, output) length pairs every block holds."""
    B = t["block"]
    prompts = quantiles(t["prompt_len"], B)
    outputs = quantiles(t["output_len"], B)
    perm = np.random.default_rng(_PAIRING_SEED).permutation(B)
    return prompts, outputs[perm]


def serve_requests(t: Dict, vocab: int, seed: int
                   ) -> List[Tuple[np.ndarray, int]]:
    """``n_requests`` (prompt token ids int32, output length) of a serving
    mix for ``seed``."""
    prompts, outputs = block_pairs(t)
    B, n = t["block"], t["n_requests"]
    r = rng(_PAIRING_SEED, 1)
    order = np.concatenate([r.permutation(B) for _ in range(-(-n // B))])
    lens = prompts[order[:n]]
    outs = outputs[order[:n]].copy()
    if t.get("warm_start") == "residual_life":
        c = t["clients"]
        w = outputs / outputs.sum()
        picked = outputs[r.choice(B, size=c, p=w)]
        outs[:c] = np.maximum(2, np.ceil(r.random(c) * picked)).astype(
            np.int64)
    ids = rng(seed, 2).integers(0, vocab, size=int(lens.sum()),
                                dtype=np.int32)
    cuts = np.cumsum(lens)[:-1]
    return [(p, int(o)) for p, o in zip(np.split(ids, cuts), outs)]


def train_tokens(t: Dict, vocab: int, seed: int, step: int, device):
    """The batch of step ``step`` (from 1): ``[batch, seq_len + 1]`` token
    ids uniform over the vocabulary, drawn on ``device``; every step's rows
    differ."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 7 * step + 11) % (2 ** 63))
    return torch.randint(0, vocab, (t["batch"], t["seq_len"] + 1),
                         generator=g, device=device, dtype=torch.int64)

