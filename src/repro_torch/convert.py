"""State carried across from the reference package.

What crosses between the two packages: profile batches, measurement grids,
response tables and calibration caches, job traces, and a model's
parameters, decode state and training state. The reference hands them over as numpy arrays,
plain dicts and JSON — this module never imports it — and the functions
here build this package's objects from them (and hand them back the same
way).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, as_device, f64
from repro_torch.core.hardware import CHIPS, MI250X_GCD, ChipSpec
from repro_torch.core.projection import ResponseTables
from repro_torch.power.jobs import JobTable, JobTrace
from repro_torch.power.surface import ProfileArray
from repro_torch.tuning.calibrate import (CalibrationResult, _result_to_doc,
                                          result_from_doc)
from repro_torch.tuning.harness import Measurement
from repro_torch.tuning.space import Candidate, KernelSpace


def profile_array(compute_s, memory_s, collective_s,
                  device=DEFAULT_DEVICE) -> ProfileArray:
    """A :class:`ProfileArray` from the reference's three arrays."""
    dev = as_device(device)
    return ProfileArray(f64(compute_s, dev), f64(memory_s, dev),
                        f64(collective_s, dev))


def profile_array_to_numpy(pa: ProfileArray) -> Tuple[Any, Any, Any]:
    return tuple(f64(x, "cpu").numpy()
                 for x in (pa.compute_s, pa.memory_s, pa.collective_s))


def measurement(kernel: str, chip_name: str, configs: Sequence, freq_fracs,
                time_s, power_w, source: Optional[str] = None,
                space: Optional[KernelSpace] = None,
                device=DEFAULT_DEVICE) -> Measurement:
    """A :class:`Measurement` from the reference's ``(kernel, chip name,
    configs, freq_fracs, time_s, power_w)``.

    ``configs`` are sequences of ``(knob, value)`` pairs. With ``space``
    (this package's space of the same kernel) each candidate gets that
    space's analytic cost; without it the costs are zero, which
    :func:`repro_torch.tuning.calibrate` never reads."""
    dev = as_device(device)
    chip = CHIPS[chip_name]
    cands = []
    for cfg in configs:
        cfg = tuple((str(k), int(v)) for k, v in cfg)
        if space is not None:
            cands.append(space._candidate(cfg))
        else:
            cands.append(Candidate(kernel=kernel, config=cfg, flops=0.0,
                                   hbm_bytes=0.0, vmem_bytes=0, grid_steps=0))
    return Measurement(
        kernel=kernel, chip=chip,
        source=source if source is not None else f"imported:{chip_name}",
        candidates=tuple(cands), freq_fracs=f64(freq_fracs, dev),
        time_s=f64(time_s, dev), power_w=f64(power_w, dev))


def response_tables(vai: Mapping, mb: Mapping, kind: str = "freq",
                    source: str = "mi250x-table-iii") -> ResponseTables:
    """:class:`ResponseTables` from the reference's two dict columns
    (``cap -> (power %, runtime %, energy %)``)."""
    def column(col):
        return {int(k): tuple(float(x) for x in v) for k, v in col.items()}
    return ResponseTables(vai=column(vai), mb=column(mb), kind=kind,
                          source=source)


def job_table_from_arrays(powers: Sequence, job_ids: Sequence[str],
                          sample_interval_s: float = 15.0,
                          arch: Optional[Sequence[str]] = None,
                          num_nodes: Optional[Sequence[int]] = None,
                          begin_time: Optional[Sequence[float]] = None,
                          intent_class: Optional[Sequence[str]] = None,
                          chip: ChipSpec = MI250X_GCD,
                          device=DEFAULT_DEVICE) -> JobTable:
    """A :class:`JobTable` on ``device`` from the reference's job traces
    given as plain data: one 1-D numpy array of powers per job, the job ids,
    and the optional per-job ``arch`` / ``num_nodes`` / ``begin_time`` /
    ``intent_class`` columns."""
    n = len(powers)

    def col(xs, default):
        return [default] * n if xs is None else list(xs)
    traces = [JobTrace(job_id=str(j), powers=np.asarray(p, dtype=np.float64),
                       sample_interval_s=sample_interval_s, arch=str(a),
                       num_nodes=int(nn), begin_time=float(b),
                       intent_class=str(c))
              for p, j, a, nn, b, c in zip(
                  powers, job_ids, col(arch, ""), col(num_nodes, 1),
                  col(begin_time, 0.0), col(intent_class, ""))]
    return JobTable(traces, chip=chip, sample_interval_s=sample_interval_s,
                    device=device)


def calibration_from_doc(doc: Dict, device=DEFAULT_DEVICE
                         ) -> CalibrationResult:
    """A :class:`CalibrationResult` from the parsed JSON of a schema-1
    calibration cache, whichever package wrote it."""
    return result_from_doc(doc, device=device)


def calibration_to_doc(result: CalibrationResult) -> Dict:
    """The schema-1 document :func:`save_calibration` writes."""
    return _result_to_doc(result)


def _tensor(x, device) -> torch.Tensor:
    """A numpy array (bf16 ones included, as ``ml_dtypes`` gives them) as a
    tensor of the same dtype on ``device``."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _unstack(tree: Mapping, i, device) -> Dict:
    """Entry ``i`` (an index, or a tuple of them over the leading axes) of
    every leaf, as tensors on ``device``."""
    return {k: (_unstack(v, i, device) if isinstance(v, Mapping)
                else _tensor(np.asarray(v)[i], device))
            for k, v in tree.items()}


def _tensors(tree: Mapping, device) -> Dict:
    return {k: (_tensors(v, device) if isinstance(v, Mapping)
                else _tensor(v, device))
            for k, v in tree.items()}


def params_from_jax(tree: Mapping, cfg, device=DEFAULT_DEVICE) -> Dict:
    """The port's parameters from the reference's ``init_params`` tree, given
    as numpy arrays: ``emb``, ``ln_f``, ``unemb`` and the unstacked ``mtp``
    subtree as they are, and ``layers`` as a list of per-layer dicts in
    layer order. A dense, MoE or SSM tree stacks its layers on axis 0 (the
    MoE, MLA and SSD leaves included); a hybrid tree stacks each place
    ``i`` of its block pattern over the groups (``groups["pos{i}"]``, group
    ``g`` being layer ``len(pattern) * g + i``) and keeps the remainder
    layers apart (``rest[j]``, layer ``len(pattern) * n_groups + j``). A
    VLM tree stacks its self layers ``[n_groups, cross_attn_every, ...]``
    (group ``g``'s layer ``j`` being layer ``cross_attn_every * g + j``)
    and its cross blocks ``[n_groups, ...]``: the port's ``{"self": [...],
    "cross": [...]}``. An enc-dec tree stacks ``encoder`` over the encoder
    layers and ``layers`` over the decoder's, each as a list here."""
    from repro_torch.models.transformer import (check_family,
                                                hybrid_group_counts)
    check_family(cfg)
    dev = as_device(device)
    out = _tensors({k: v for k, v in tree.items()
                    if k not in ("layers", "encoder")}, dev)
    layers = tree["layers"]
    if cfg.family == "vlm":
        n_groups = cfg.n_layers // cfg.cross_attn_every
        out["layers"] = {
            "self": [_unstack(layers["self"], (g, j), dev)
                     for g in range(n_groups)
                     for j in range(cfg.cross_attn_every)],
            "cross": [_unstack(layers["cross"], g, dev)
                      for g in range(n_groups)]}
    elif cfg.family == "encdec":
        out["encoder"] = [_unstack(tree["encoder"], i, dev)
                          for i in range(cfg.n_encoder_layers)]
        out["layers"] = [_unstack(layers, i, dev)
                         for i in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_groups, _ = hybrid_group_counts(cfg)
        n_pat = len(cfg.block_pattern)
        out["layers"] = [_unstack(layers["groups"][f"pos{i}"], g, dev)
                         for g in range(n_groups) for i in range(n_pat)]
        out["layers"] += [_tensors(r, dev) for r in layers["rest"]]
    else:
        out["layers"] = [_unstack(layers, i, dev)
                         for i in range(cfg.n_layers)]
    return out


def decode_state_from_jax(state: Mapping, device=DEFAULT_DEVICE) -> Dict:
    """The port's decode state from the reference's, given as numpy arrays:
    ``{"layers": {...}}`` stacked over the layers (the KV cache ``k`` /
    ``v``, the MLA cache ``c_kv`` / ``k_rope`` or the SSM state ``h`` /
    ``conv``) as it is; a hybrid state ``{"groups": {"pos{i}": stacked over
    the groups}, "rest": [each with a leading axis of 1]}`` as the list of
    per-layer dicts in layer order; a VLM or enc-dec state ``{"self": {"k",
    "v"}, "cross": {"k", "v"}}`` with the cross K / V as they are and the
    self cache stacked over the layers (a VLM's ``[G, cross_attn_every, B,
    M, ...]`` in layer order, ``[G * cross_attn_every, B, M, ...]``)."""
    dev = as_device(device)
    if "cross" in state:
        cross = {k: _tensor(v, dev) for k, v in state["cross"].items()}
        self_kv = {k: _tensor(v, dev) for k, v in state["self"].items()}
        # a VLM stacks its self cache over [groups, layers of a group]
        self_kv = {k: v.flatten(0, 1) if v.ndim == 6 else v
                   for k, v in self_kv.items()}
        return {"self": self_kv, "cross": cross}
    if "groups" not in state:
        return {"layers": {k: _tensor(v, dev)
                           for k, v in state["layers"].items()}}
    groups = state["groups"]
    n_pat = len(groups)
    n_groups = len(next(iter(groups["pos0"].values())))
    layers = [_unstack(groups[f"pos{i}"], g, dev)
              for g in range(n_groups) for i in range(n_pat)]
    layers += [_unstack(r, 0, dev) for r in state["rest"]]
    return {"layers": layers}


def train_state_from_jax(state: Mapping, cfg, device=DEFAULT_DEVICE) -> Dict:
    """The port's training state from the reference's ``{"params", "opt":
    {"m", "v", "step"}, ["grad_error"]}``, given as numpy arrays: every
    params-shaped subtree through :func:`params_from_jax` (bf16 moments stay
    bf16), ``step`` an int32 0-d tensor."""
    dev = as_device(device)
    opt = state["opt"]
    out = {"params": params_from_jax(state["params"], cfg, dev),
           "opt": {"m": params_from_jax(opt["m"], cfg, dev),
                   "v": params_from_jax(opt["v"], cfg, dev),
                   "step": torch.tensor(int(np.asarray(opt["step"])),
                                        dtype=torch.int32, device=dev)}}
    if "grad_error" in state:
        out["grad_error"] = params_from_jax(state["grad_error"], cfg, dev)
    return out
