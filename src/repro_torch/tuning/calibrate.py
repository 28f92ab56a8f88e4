"""Calibration inverter — measured kernel grids become ResponseTables.

A :class:`~repro_torch.tuning.harness.Measurement` grid (config x frequency
step time and power) is inverted through
:meth:`TransferSurface.infer_profiles` into one canonical roofline profile
per candidate, the profiles are split into the paper's two benchmark
families by their structural mode (compute-dominant -> the VAI column,
memory-dominant -> the MB column), and
:func:`~repro_torch.power.surface.family_response_tables` synthesizes Table
III-style columns from them — a :class:`~repro_torch.core.projection.
ResponseTables` every projection can consume.

Three ways to get one:

* :func:`calibrate` — invert an explicit Measurement;
* :func:`calibrated_tables` — the registry/default pipeline behind the
  ``"calibrated:<kernel>"`` table spelling: a registered calibration wins,
  otherwise the kernel's default config space is enumerated and measured on
  the hermetic :class:`~repro_torch.tuning.harness.SimulatedBackend`
  (cached per (kernel, kind, chip, device));
* :func:`load_calibration` — a persisted JSON cache.
  :func:`save_calibration` round-trips **bit-for-bit**: every float is
  serialized via ``repr`` (shortest round-trip), so save -> load -> save
  reproduces the file byte-for-byte and the loaded tables equal the
  originals exactly. The file format (schema 1) is the reference
  package's: a cache written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch import DEFAULT_DEVICE, as_device, f64
from repro_torch.core.hardware import ChipSpec, H100_SXM
from repro_torch.core.power_model import ChipModel
from repro_torch.core.projection import ResponseTables
from repro_torch.tuning.harness import Measurement, SimulatedBackend
from repro_torch.tuning.space import (Config, FlashAttentionSpace,
                                      MembwSpace, VaiSpace)

#: Kernel name -> default config-space factory for the zero-setup
#: ``calibrated_tables`` pipeline. VAI spans the roofline ridge
#: (AI = loopsize/8 flops/byte) so both the compute and memory family are
#: populated.
SPACES = {
    "vai": lambda chip, device=DEFAULT_DEVICE: VaiSpace(
        n_elems=1 << 18, loopsizes=(0, 2, 8, 32, 128, 512, 1024),
        block_rows_options=(128, 256, 512, 1024), chip=chip, device=device),
    "membw": lambda chip, device=DEFAULT_DEVICE: MembwSpace(
        total_rows=1 << 14, n_iters=64,
        n_chunks_options=(1, 2, 4, 8, 16, 32), chip=chip, device=device),
    "flash_attention": lambda chip, device=DEFAULT_DEVICE: FlashAttentionSpace(
        batch_heads=4, seq_q=1024, head_dim=128,
        block_q_options=(32, 64, 128), block_k_options=(64, 128), chip=chip,
        device=device),
}

_SCHEMA = 1


@dataclass(frozen=True)
class CalibrationResult:
    """One inverted measurement grid and the tables it produced.

    ``profiles`` is the ``(N, 3)`` float64 tensor of inferred canonical
    roofline profiles (compute_s, memory_s, collective_s per candidate);
    ``fit_rms_pct`` is the RMS relative error (percent) of the inverted
    model re-predicting the *full* measured (config, freq) grid — the
    calibration's own goodness-of-fit diagnostic.
    """

    kernel: str
    chip: ChipSpec
    source: str                       # measurement provenance
    kind: str
    configs: Tuple[Config, ...]
    freq_fracs: Tuple[float, ...]
    profiles: torch.Tensor            # (N, 3)
    tables: ResponseTables
    fit_rms_pct: float

    def profile_array(self):
        from repro_torch.power.surface import ProfileArray
        return ProfileArray(self.profiles[:, 0], self.profiles[:, 1],
                            self.profiles[:, 2])

    def __repr__(self) -> str:
        return (f"CalibrationResult({self.kernel!r}, "
                f"{len(self.configs)} configs, kind={self.kind!r}, "
                f"fit_rms={self.fit_rms_pct:.2f}%)")


def _family_split(surf, pa) -> Dict[str, torch.Tensor]:
    """Candidate indices for the vai (compute) / mb (memory) columns by
    structural mode at nominal frequency; an empty family falls back to
    the full candidate set (a kernel family that is e.g. all
    memory-bound still yields both columns)."""
    mode = surf.classify_mode_idx(pa, 1.0)
    idx = torch.arange(mode.shape[0], device=mode.device)
    fams = {"vai": idx[mode >= 3], "mb": idx[mode == 2]}
    return {k: (v if v.numel() else idx) for k, v in fams.items()}


def calibrate(meas: Measurement, caps: Optional[Sequence[float]] = None,
              kind: str = "freq", grid: int = 64) -> CalibrationResult:
    """Invert a measurement grid into calibrated per-kernel ResponseTables,
    on the device the measurement lies on.

    The nominal-frequency column pins each candidate's canonical profile
    via :meth:`TransferSurface.infer_profiles` (``step_time(inferred,
    f_nom) == measured time`` exactly); the remaining columns only score
    the fit. Columns are synthesized by
    :func:`~repro_torch.power.surface.family_response_tables` at ``caps``
    (default: the chip's own cap ladder for ``kind``), with the candidate
    families split by structural mode.
    """
    from repro_torch.power.surface import ProfileArray, family_response_tables
    model = ChipModel(meas.chip)
    surf = model.surface(meas.device)
    j0 = meas.nominal_column()
    f0 = float(meas.freq_fracs[j0])
    inferred = surf.infer_profiles(meas.power_w[:, j0], f0,
                                   meas.time_s[:, j0])
    profiles = torch.stack([inferred.compute_s, inferred.memory_s,
                            inferred.collective_s], dim=1)
    pa = ProfileArray(profiles[:, 0], profiles[:, 1], profiles[:, 2])

    # goodness of fit: re-predict the whole grid from the inverted profiles
    t_hat = surf.step_time(pa.expand(), meas.freq_fracs)
    p_hat = surf.power_w(pa.expand(), meas.freq_fracs)
    rel = torch.cat([
        (t_hat / torch.clamp(meas.time_s, min=1e-12) - 1.0).reshape(-1),
        (p_hat / torch.clamp(meas.power_w, min=1e-12) - 1.0).reshape(-1)])
    fit_rms_pct = float(100.0 * torch.sqrt(torch.mean(rel * rel)))

    fams = _family_split(surf, pa)
    families = {
        name: ProfileArray(profiles[idx, 0], profiles[idx, 1],
                           profiles[idx, 2])
        for name, idx in fams.items()}
    source = f"calibrated:{meas.kernel}:{meas.chip.name}"
    tables = family_response_tables(model, families, caps=caps, kind=kind,
                                    grid=grid, device=meas.device,
                                    source=source)
    return CalibrationResult(
        kernel=meas.kernel, chip=meas.chip, source=meas.source, kind=kind,
        configs=meas.configs,
        freq_fracs=tuple(meas.freq_fracs.tolist()),
        profiles=profiles, tables=tables, fit_rms_pct=fit_rms_pct)


# ---------------------------------------------------------------------------
# Registry + default pipeline (the "calibrated:<kernel>" table spelling)
# ---------------------------------------------------------------------------
_REGISTRY: Dict[Tuple[str, str, ChipSpec], CalibrationResult] = {}


def _spec(chip) -> ChipSpec:
    return ChipModel(chip).spec if chip is not None else H100_SXM


def register_calibration(result: CalibrationResult) -> CalibrationResult:
    """Register a calibration so :func:`calibrated_tables` serves its tables
    for (kernel, kind, chip) lookups. Returns the result for chaining.
    Re-registering overwrites."""
    _REGISTRY[(result.kernel, result.kind, result.chip)] = result
    return result


def registered_calibration(kernel: str, kind: str = "freq",
                           chip: Union[None, str, ChipSpec, ChipModel] = None
                           ) -> Optional[CalibrationResult]:
    return _REGISTRY.get((kernel, kind, _spec(chip)))


@lru_cache(maxsize=None)
def _default_calibration(kernel: str, kind: str, spec: ChipSpec,
                         device: str) -> CalibrationResult:
    factory = SPACES.get(kernel)
    if factory is None:
        raise ValueError(
            f"unknown kernel {kernel!r} for calibrated tables; "
            f"known: {sorted(SPACES)}")
    space = factory(spec, device)
    meas = SimulatedBackend(spec, device=device).measure(space)
    return calibrate(meas, kind=kind)


def calibrated_tables(kernel: str, kind: str = "freq",
                      chip: Union[None, str, ChipSpec, ChipModel] = None,
                      device=DEFAULT_DEVICE) -> ResponseTables:
    """Tuner-derived ResponseTables for a kernel of this package — the
    backend of the ``"calibrated:<kernel>"`` tables spelling.

    A calibration previously stored with :func:`register_calibration`
    (e.g. loaded from a cache file or produced on the card) wins;
    otherwise the kernel's default config space (:data:`SPACES`) is
    enumerated and measured on the deterministic
    :class:`~repro_torch.tuning.harness.SimulatedBackend` on ``device``,
    cached per (kernel, kind, chip, device).
    """
    spec = _spec(chip)
    hit = _REGISTRY.get((kernel, kind, spec))
    if hit is not None:
        return hit.tables
    return _default_calibration(kernel, kind, spec,
                                str(as_device(device))).tables


# ---------------------------------------------------------------------------
# JSON calibration cache (bit-for-bit persistence)
# ---------------------------------------------------------------------------
def _result_to_doc(result: CalibrationResult) -> Dict:
    t = result.tables
    return {
        "schema": _SCHEMA,
        "kernel": result.kernel,
        "chip": dataclasses.asdict(result.chip),
        "source": result.source,
        "kind": result.kind,
        "fit_rms_pct": float(result.fit_rms_pct),
        "configs": [[[k, int(v)] for k, v in cfg] for cfg in result.configs],
        "freq_fracs": [float(f) for f in result.freq_fracs],
        "profiles": f64(result.profiles, "cpu").tolist(),
        "tables": {
            "kind": t.kind,
            "source": t.source,
            "vai": {str(k): [float(x) for x in v]
                    for k, v in t.vai.items()},
            "mb": {str(k): [float(x) for x in v]
                   for k, v in t.mb.items()},
        },
    }


def save_calibration(result: CalibrationResult, path: str) -> str:
    """Persist a calibration to a JSON cache file.

    Floats serialize via ``repr`` (json's default), the shortest string
    that round-trips the exact float64 — so ``load_calibration`` restores
    the tables bit-for-bit and a save -> load -> save cycle reproduces
    the file byte-for-byte (sorted keys, fixed separators)."""
    doc = _result_to_doc(result)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, sort_keys=True, separators=(",", ":"))
        fh.write("\n")
    os.replace(tmp, path)
    return path


def result_from_doc(doc: Dict, device=DEFAULT_DEVICE,
                    where: str = "<doc>") -> CalibrationResult:
    """A :class:`CalibrationResult` from a parsed schema-1 cache document."""
    if doc.get("schema") != _SCHEMA:
        raise ValueError(
            f"unsupported calibration cache schema {doc.get('schema')!r} "
            f"in {where!r}; this build reads schema {_SCHEMA}")
    chip = ChipSpec(**doc["chip"])
    td = doc["tables"]
    tables = ResponseTables(
        vai={int(k): tuple(v) for k, v in td["vai"].items()},
        mb={int(k): tuple(v) for k, v in td["mb"].items()},
        kind=td["kind"], source=td["source"])
    return CalibrationResult(
        kernel=doc["kernel"], chip=chip, source=doc["source"],
        kind=doc["kind"],
        configs=tuple(tuple((k, int(v)) for k, v in cfg)
                      for cfg in doc["configs"]),
        freq_fracs=tuple(doc["freq_fracs"]),
        profiles=f64(doc["profiles"], as_device(device)).reshape(-1, 3),
        tables=tables, fit_rms_pct=doc["fit_rms_pct"])


def load_calibration(path: str, device=DEFAULT_DEVICE) -> CalibrationResult:
    """Restore a :func:`save_calibration` cache file (bit-for-bit); the
    profiles go to ``device``."""
    with open(path) as fh:
        doc = json.load(fh)
    return result_from_doc(doc, device=device, where=path)
