"""Modal decomposition of fleet power telemetry (paper §V-A/B).

Given per-GPU power samples, build the power histogram (paper Fig. 8),
detect its local maxima (the per-domain "zones of operation", Fig. 9), and
decompose hours/energy into the paper's four modes (Table IV). Everything
is a float64 tensor program on the device the samples lie on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import DEFAULT_DEVICE, as_device, f64
from repro_torch.core.hardware import MODES, Mode, MI250X_GCD, ChipSpec


def scaled_mode_bounds(chip: ChipSpec) -> List[Tuple[Mode, float, float]]:
    """The paper's Table IV band boundaries, rescaled from the MI250X power
    envelope to ``chip``'s (idle, TDP) envelope."""
    src = MI250X_GCD
    out = []
    for m in MODES:
        def rescale(w: float) -> float:
            if w == float("inf"):
                return float("inf")
            frac = (w - src.idle_w) / (src.tdp_w - src.idle_w)
            return chip.idle_w + frac * (chip.tdp_w - chip.idle_w)
        lo = rescale(m.lo_w) if m.lo_w > 0 else 0.0
        out.append((m, lo, rescale(m.hi_w)))
    return out


def classify_power(power_w, chip: ChipSpec = MI250X_GCD,
                   device=None) -> torch.Tensor:
    """Mode index (1..4, int32) per sample: ``lo <= p < hi`` per band, and
    whatever falls in no band (negative or NaN readings) counts as mode 1."""
    p = f64(power_w, device)
    out = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
    for mode, lo, hi in scaled_mode_bounds(chip):
        sel = (p >= lo) & (p < hi)
        out[sel] = mode.idx
    out[out == 0] = 1
    return out


@dataclass
class ModalDecomposition:
    hours_pct: Dict[int, float]          # mode idx -> % of GPU-hours
    energy_mwh: Dict[int, float]         # mode idx -> MWh
    total_energy_mwh: float
    sample_interval_s: float

    def energy_pct(self) -> Dict[int, float]:
        t = max(self.total_energy_mwh, 1e-12)
        return {k: 100.0 * v / t for k, v in self.energy_mwh.items()}


@dataclass
class BatchModalDecomposition:
    """Per-job modal decomposition of a ``(jobs, samples)`` power matrix.

    Column ``i`` of every tensor is mode ``MODES[i]`` (idx ``i + 1``); the
    tensors are one vectorized pass over the whole matrix, never a Python
    loop per job. :meth:`job` lifts one row back into the dict-keyed
    :class:`ModalDecomposition` the scalar pipeline speaks.
    """
    hours_pct: torch.Tensor              # (jobs, n_modes) % of job samples
    energy_mwh: torch.Tensor             # (jobs, n_modes) MWh
    total_energy_mwh: torch.Tensor       # (jobs,)
    sample_interval_s: float
    n_samples: torch.Tensor              # (jobs,) valid samples per job

    @property
    def n_jobs(self) -> int:
        return int(self.total_energy_mwh.shape[0])

    def energy_pct(self) -> torch.Tensor:
        t = torch.clamp(self.total_energy_mwh, min=1e-12)
        return 100.0 * self.energy_mwh / t[:, None]

    def dominant_mode(self) -> torch.Tensor:
        """Mode idx (1..4) holding the most energy of each job."""
        return torch.argmax(self.energy_mwh, dim=1).to(torch.int32) + 1

    def hours_frac(self, mode_idx: int) -> torch.Tensor:
        """Per-job fraction of samples spent in ``mode_idx`` (0..1)."""
        return self.hours_pct[:, mode_idx - 1] / 100.0

    def job(self, j: int) -> ModalDecomposition:
        hours = self.hours_pct[j].tolist()
        energy = self.energy_mwh[j].tolist()
        return ModalDecomposition(
            hours_pct={m.idx: hours[i] for i, m in enumerate(MODES)},
            energy_mwh={m.idx: energy[i] for i, m in enumerate(MODES)},
            total_energy_mwh=float(self.total_energy_mwh[j]),
            sample_interval_s=self.sample_interval_s)

    def aggregate(self) -> ModalDecomposition:
        """Sum over jobs; hours_pct is weighted by per-job valid-sample
        counts, so it equals decomposing the concatenated samples. The
        sums over jobs are plain ``Tensor.sum`` calls (the device's own
        order)."""
        e = self.energy_mwh.sum(dim=0).tolist()
        tot = float(self.total_energy_mwh.sum())
        n = torch.clamp(self.n_samples, min=0).to(torch.float64)
        total_n = max(float(n.sum()), 1.0)
        hours = ((self.hours_pct * n[:, None]).sum(dim=0) / total_n).tolist()
        return ModalDecomposition(
            hours_pct={m.idx: hours[i] for i, m in enumerate(MODES)},
            energy_mwh={m.idx: e[i] for i, m in enumerate(MODES)},
            total_energy_mwh=tot, sample_interval_s=self.sample_interval_s)


# Segment width of the chunk-associative reduction below: a streaming
# consumer buffers samples into the same aligned 128-sample segments.
STREAM_SEGMENT = 128
_LANES = 8


def _segment_sums(seg: torch.Tensor) -> torch.Tensor:
    """Sum of each 128-sample segment (last axis), in one fixed order on
    every device: eight running sums fed eight samples at a time, in
    sequence, then the combine tree ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``.
    It is the order a pairwise summation takes on a 128-element block, so
    no device's own reduction order enters the result."""
    y = seg.reshape(seg.shape[:-1] + (STREAM_SEGMENT // _LANES, _LANES))
    acc = y[..., 0, :]
    for i in range(1, STREAM_SEGMENT // _LANES):
        acc = acc + y[..., i, :]
    return ((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])) \
        + ((acc[..., 4] + acc[..., 5]) + (acc[..., 6] + acc[..., 7]))


def stream_sum(x, axis: int = -1, device=None) -> torch.Tensor:
    """Deterministic *chunk-associative* summation along ``axis``.

    The axis is cut into fixed :data:`STREAM_SEGMENT`-element segments
    aligned to its start (the last one zero-padded), each segment is
    reduced in the fixed order of :func:`_segment_sums`, and the segment
    sums combine strictly left to right in an explicit fold. A streaming
    consumer that buffers samples into the same aligned segments and folds
    them in the same order reproduces this reduction bit-for-bit over
    arbitrary shard boundaries. Neither ``Tensor.sum`` nor ``cumsum`` is
    used: their order differs between devices and with the length.
    """
    x = f64(x, device)
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    nseg = max(-(-n // STREAM_SEGMENT), 1)
    pad = nseg * STREAM_SEGMENT - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    seg = _segment_sums(x.reshape(x.shape[:-1] + (nseg, STREAM_SEGMENT)))
    total = seg[..., 0]
    for k in range(1, nseg):
        total = total + seg[..., k]
    return total


def decompose_batch(power_w, sample_interval_s: float = 15.0,
                    chip: ChipSpec = MI250X_GCD, mask=None,
                    device=None) -> BatchModalDecomposition:
    """Vectorized modal decomposition over a ``(jobs, samples)`` matrix.

    ``mask`` (same shape, bool) marks the valid samples of each row —
    variable-length job traces are right-padded and the padding masked out.
    One classification pass plus one masked reduction per mode; no Python
    loop over jobs. Float reductions run through the chunk-associative
    :func:`stream_sum`. A tensor is decomposed on the device it lies on.
    """
    p = torch.atleast_2d(f64(power_w, device))
    modes = classify_power(p, chip)
    valid = None if mask is None else \
        torch.as_tensor(mask, dtype=torch.bool, device=p.device)
    if valid is None:
        n_valid = torch.full((p.shape[0],), p.shape[1], dtype=torch.int64,
                             device=p.device)
    else:
        n_valid = valid.sum(dim=1)
    n = torch.clamp(n_valid, min=1)
    to_mwh = sample_interval_s / 3600.0 / 1e6        # W*s -> MWh
    hours = torch.empty((p.shape[0], len(MODES)), dtype=torch.float64,
                        device=p.device)
    energy = torch.empty_like(hours)
    for i, m in enumerate(MODES):
        sel = modes == m.idx
        if valid is not None:
            sel = sel & valid
        hours[:, i] = 100.0 * sel.sum(dim=1).to(torch.float64) / n
        energy[:, i] = stream_sum(p * sel, axis=1) * to_mwh
    total = stream_sum(p if valid is None else p * valid, axis=1) * to_mwh
    return BatchModalDecomposition(hours, energy, total, sample_interval_s,
                                   n_samples=n_valid)


def decompose(power_w, sample_interval_s: float = 15.0,
              chip: ChipSpec = MI250X_GCD, device=None) -> ModalDecomposition:
    """power_w: flat array of per-GPU power samples (the paper's 15 s
    out-of-band channel). The single-job special case of
    :func:`decompose_batch` — one engine for both paths."""
    flat = f64(power_w, device).reshape(1, -1)
    return decompose_batch(flat, sample_interval_s, chip).job(0)


def power_histogram(power_w, bins: int = 120, max_w: Optional[float] = None,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fleet power histogram (paper Fig. 8): (bin centers, density).

    An empty sample array yields an empty histogram (two size-0 tensors).
    With an explicit ``max_w``, samples above it are clipped into the top
    bin rather than silently dropped — every recorded watt stays accounted
    for.
    """
    p = f64(power_w, device).reshape(-1)
    if p.numel() == 0:
        empty = torch.empty(0, dtype=torch.float64, device=p.device)
        return empty, empty.clone()
    if max_w is not None:
        hi = float(max_w)
        p = torch.clamp(p, max=hi)       # overflow -> top bin, not dropped
    else:
        hi = float(p.max()) * 1.02 + 1e-9
    counts = torch.histc(p, bins=bins, min=0.0, max=hi)
    edges = torch.linspace(0.0, hi, bins + 1, dtype=torch.float64,
                           device=p.device)
    hist = counts / counts.sum() / (edges[1:] - edges[:-1])
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, hist


def detect_peaks(centers, hist, smooth: int = 3,
                 min_rel_height: float = 0.08) -> List[float]:
    """Local maxima of the (smoothed) power histogram — the paper's
    "prevalent zones of operation" in Fig. 8/9. The histogram is a few
    hundred bins, so the walk over it runs on the host."""
    c = f64(centers, "cpu").tolist()
    h = f64(hist, "cpu")
    n = h.numel()
    if n == 0:
        return []
    if smooth > 1:
        # moving average, "same"-sized and zero-padded at both ends
        padded = torch.nn.functional.pad(h, (smooth - 1, smooth - 1))
        full = sum(padded[i:i + n + smooth - 1] * (1.0 / smooth)
                   for i in range(smooth))
        if n >= smooth:
            start = (smooth - 1) // 2
            h = full[start:start + n]
        else:
            start = (n - 1) // 2
            h = full[start:start + smooth]
    h = h.tolist()
    peaks = []
    thresh = min_rel_height * max(h)
    for i in range(1, len(h) - 1):
        if h[i] >= h[i - 1] and h[i] > h[i + 1] and h[i] >= thresh:
            peaks.append(float(c[i]))
    return peaks


def synth_fleet_powers(n_samples: int, seed: int = 0,
                       hours_pct: Optional[Dict[int, float]] = None,
                       chip: ChipSpec = MI250X_GCD,
                       generator: Optional[torch.Generator] = None,
                       device=DEFAULT_DEVICE) -> torch.Tensor:
    """Synthetic fleet telemetry calibrated so mode GPU-hours match the
    paper's Table IV (the raw Frontier dataset is not public). Drawn on
    ``device`` from ``generator`` (default: a new ``torch.Generator`` on
    that device seeded with ``seed``); returns exactly ``n_samples`` float64
    samples."""
    dev = as_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    hours = hours_pct or {m.idx: m.gpu_hours_pct for m in MODES}
    bounds = {m.idx: (lo, hi) for m, lo, hi in scaled_mode_bounds(chip)}
    # per-mode power distributions (means reflect paper Figs. 8/9 peaks)
    params = {1: (120.0, 35.0), 2: (300.0, 55.0), 3: (480.0, 35.0),
              4: (575.0, 10.0)}
    # per-mode counts round independently, so their sum can drift from
    # n_samples by a few; pin the total by folding the drift into the
    # largest mode (deterministic, <= len(hours)/2 samples of shift)
    ks = {idx: int(round(n_samples * pct / 100.0))
          for idx, pct in hours.items()}
    drift = n_samples - sum(ks.values())
    if drift:
        largest = max(ks, key=lambda i: (ks[i], -i))
        ks[largest] = max(ks[largest] + drift, 0)
    powers = torch.empty(sum(ks.values()), dtype=torch.float64, device=dev)
    start = 0
    for idx, k in ks.items():
        lo, hi = bounds[idx]
        hi = min(hi, chip.tdp_w * 1.1)
        mu, sd = params[idx]
        part = powers[start:start + k]       # a view: filled in place
        part.normal_(mu, sd, generator=generator)
        part.clamp_(min=lo + 1e-3, max=hi - 1e-3)
        start += k
    powers = powers[torch.randperm(powers.numel(), generator=generator,
                                   device=dev)]
    if powers.numel() != n_samples:      # degenerate tiny-n clamp fallback
        if powers.numel() == 0:
            return torch.zeros(n_samples, dtype=torch.float64, device=dev)
        reps = -(-n_samples // powers.numel())
        powers = powers.repeat(reps)[:n_samples]
    return powers
