"""Roofline terms of a model step.

The artifact half prices what :mod:`repro_torch.core.hlo_cost` counted on
one rank (its flops, bytes and collective bytes) as the three roofline
terms on a chip: :func:`roofline_from_artifacts` and
:class:`RooflineReport`, the reference's arithmetic. The reference reads
its counts from the compiled, partitioned XLA module; the port's come from
the ops one rank's step dispatches.

``memory_floor_s`` and ``model_flops`` are the reference's formulas,
copied: they read only the config and the chip spec.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.hardware import ChipSpec, H100_SXM
from repro_torch.core.hlo_cost import COLLECTIVE_OPS, CostTotals


def collective_bytes(totals: CostTotals) -> Dict:
    """Per-op-type operand bytes a rank's step put on the wire, from the
    counter's totals: each collective type that ran, ``"__counts__"`` (its
    number of calls) and ``"total"``, as the reference's dict."""
    out: Dict = {op: totals.collective_bytes[op] for op in COLLECTIVE_OPS
                 if totals.collective_counts.get(op)}
    out["__counts__"] = {op: totals.collective_counts[op]
                         for op in COLLECTIVE_OPS
                         if totals.collective_counts.get(op)}
    out["total"] = sum(v for k, v in out.items()
                       if k not in ("__counts__", "total"))
    return out


@dataclass
class RooflineReport:
    """All three terms in *seconds per step*, per-chip basis. ``chip`` is
    the spec the terms were priced on; ``mfu`` divides by its peak (the
    reference divides by ``TPU_V5E``'s whatever chip it priced on; the two
    agree at ``TPU_V5E``)."""
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops_global: float
    chips: int
    chip: ChipSpec = H100_SXM

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline (perfect-overlap) step time estimate."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops — catches remat/padding waste."""
        counted_global = self.flops_per_dev * self.chips
        return (self.model_flops_global / counted_global if counted_global
                else 0.0)

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline step time."""
        denom = self.step_time_s * self.chips * self.chip.peak_flops
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu, "chips": self.chips,
        }


def roofline_from_artifacts(cost: Dict, coll: Dict, chips: int,
                            model_flops_global: float,
                            chip: ChipSpec = H100_SXM) -> RooflineReport:
    """``cost`` (``"flops"``, ``"bytes accessed"``) and ``coll``
    (``"total"``) are one rank's counts of its step."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.get("total", 0))
    return RooflineReport(
        compute_s=flops / chip.peak_flops,
        memory_s=byts / chip.hbm_bw,
        collective_s=cbytes / chip.ici_bw,
        flops_per_dev=flops, bytes_per_dev=byts,
        coll_bytes_per_dev=cbytes,
        model_flops_global=model_flops_global,
        chips=chips, chip=chip)


def memory_floor_s(cfg, shape, chips: int,
                   chip: ChipSpec = H100_SXM) -> float:
    """Idealized-fusion lower bound on the memory term: weight passes +
    residual-stream activation traffic + optimizer/cache state."""
    n_total = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    d = cfg.d_model
    L = cfg.n_layers + cfg.n_encoder_layers
    param_dev = n_total * 2 / chips                      # bf16, fully sharded
    if shape.kind == "train":
        tokens_dev = shape.global_batch * shape.seq_len / chips * \
            (16 if chips >= 256 else 1)                  # batch over data only
        act = 32 * L * tokens_dev * d * 2                # fwd+remat+bwd, bf16
        opt = n_total * 8 / chips * 3                    # m,v f32 r/w + grad
        return (3 * param_dev + opt + act) / chip.hbm_bw
    if shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / chips * \
            (16 if chips >= 256 else 1)
        act = 10 * L * tokens_dev * d * 2
        return (param_dev + act) / chip.hbm_bw
    # decode: weights once + KV/state cache once
    active_dev = n_active * 2 / chips
    cache = 0.0
    if cfg.use_mla:
        cache = (shape.global_batch * shape.seq_len
                 * (cfg.kv_lora_rank + cfg.qk_rope_dim) * cfg.n_layers * 2)
    elif cfg.family in ("dense", "moe", "vlm", "encdec"):
        hd = cfg.resolved_head_dim
        cache = (shape.global_batch * shape.seq_len * cfg.n_kv_heads * hd
                 * 2 * cfg.n_layers * 2)
    elif cfg.family == "hybrid":
        cache = (shape.global_batch * min(cfg.local_window, shape.seq_len)
                 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
                 * cfg.n_layers // 3 * 2)
    elif cfg.family == "ssm":
        d_in = cfg.ssm_expand * d
        cache = shape.global_batch * d_in * cfg.ssm_state * 4 * cfg.n_layers
    return (active_dev + cache / chips) / chip.hbm_bw


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode counts one
    token per sequence."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: forward-only, 1 token
