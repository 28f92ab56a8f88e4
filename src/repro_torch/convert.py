"""State carried across from the reference package.

What crosses between the two packages: profile batches, measurement grids,
response tables and calibration caches, and a model's parameters and decode
state. The reference hands them over as numpy arrays, plain dicts and JSON —
this module never imports it — and the functions here build this package's
objects from them (and hand them back the same way).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, as_device, f64
from repro_torch.core.hardware import CHIPS
from repro_torch.core.projection import ResponseTables
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


def _unstack(tree: Mapping, i: int, device) -> Dict:
    return {k: (_unstack(v, i, device) if isinstance(v, Mapping)
                else _tensor(np.asarray(v)[i], device))
            for k, v in tree.items()}


def params_from_jax(tree: Mapping, cfg, device=DEFAULT_DEVICE) -> Dict:
    """The port's parameters from the reference's ``init_params`` tree of a
    dense config, given as numpy arrays: ``emb``, ``ln_f``, ``unemb`` as
    they are, and ``layers`` — arrays stacked over the layers on axis 0 —
    as a list of per-layer dicts."""
    from repro_torch.models.transformer import check_family
    check_family(cfg)
    dev = as_device(device)
    out = {k: _tensor(v, dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_unstack(tree["layers"], i, dev)
                     for i in range(cfg.n_layers)]
    return out


def decode_state_from_jax(state: Mapping, device=DEFAULT_DEVICE) -> Dict:
    """The port's decode state (``{"layers": {"k", "v"}}``, stacked over
    the layers) from the reference's, given as numpy arrays."""
    dev = as_device(device)
    return {"layers": {k: _tensor(v, dev)
                       for k, v in state["layers"].items()}}
