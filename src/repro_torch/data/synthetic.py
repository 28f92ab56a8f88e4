"""Deterministic synthetic data pipeline.

Tokens are a fixed function of (seed, step), so a restarted job resumes
with byte-identical batches, which the restart tests rely on. A light
Markov structure makes the LM loss fall during a run (uniform noise would
pin CE at ln V). Batches are numpy arrays drawn as the reference draws
them, bit for bit; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _tokens_for(step: int, batch: int, seqlen: int, vocab: int,
                seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    # Markov-ish stream: next token = prev * a + noise (mod vocab)
    x = rng.integers(0, vocab, size=(batch, 1), dtype=np.int64)
    a = 31
    noise = rng.integers(0, max(vocab // 16, 2), size=(batch, seqlen),
                         dtype=np.int64)
    out = np.empty((batch, seqlen), dtype=np.int64)
    prev = x[:, 0]
    for t in range(seqlen):
        prev = (prev * a + noise[:, t]) % vocab
        out[:, t] = prev
    return out.astype(np.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """One global batch: tokens [B, S+1] plus stub frontend embeddings for
    multimodal backbones (precomputed patch/frame embeddings)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _tokens_for(step, B, S + 1, cfg.vocab_size, seed)}
    if cfg.frontend_seq:
        rng = np.random.default_rng(np.uint64(seed * 7_000_003 + step))
        batch["frontend"] = (rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


@dataclasses.dataclass
class SyntheticPipeline:
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    start_step: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = self.start_step
        while True:
            yield make_batch(self.cfg, self.shape, step, self.seed)
            step += 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return make_batch(self.cfg, self.shape, step, self.seed)
