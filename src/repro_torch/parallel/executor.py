"""Sharded execution of the hot streaming-analysis path on the card.

:class:`ShardedExecutor` runs the per-shard work of
:func:`repro_torch.power.stream.replay` (profile inversion and batched policy
decisions) and the segment sums of the streaming modal reduction on one or
more devices, with the names, arguments and contracts of the reference's
``repro.parallel.executor``. Its results are the port's plain path's, bit
for bit on the same device:

* the decision body *is* the plain path — ``ChipModel(rec).surface(dev)
  .infer_profiles(...)`` on the recorded (or power-band-classified) modes,
  then ``decide_batch(policy, profiles, model, device=dev)`` — run on fewer
  or reordered samples. Every op in it is elementwise in ``(power, mode)``
  and rounds on its own in eager float64 (nothing is fused or compiled), so
  a sample's decision does not depend on which samples share its call,
  where it lies in it, or how many devices split it. The reference's
  runtime-scalar pack, optimization barriers and AVX-only compile option
  guard against rewrites of its compiler; eager torch makes none, so none
  of them is here;
* the segment sums are the stream's own ``_contrib`` rows reduced by
  :func:`repro_torch.core.modal._segment_sums`, whose fixed order is the
  same on every device.

Throughput comes from the reference's levers:

* dedup — a shard collapses to its unique ``(power, mode)`` pairs before
  the decision body, and the decisions are gathered back (``dedup=``);
* a memo across shards, keyed on powers quantized to 0.1 W (then 0.01 W):
  a warm shard of quantized telemetry is a few table gathers and launches
  no decision body at all. A key that two distinct powers share is caught
  by comparing every sample, and turns the memo off for that signature;
* chunking — the decision body runs on at most ``chunk`` samples a call, so
  its temporaries (the power-cap policy's ``(n, grid + 1)`` plane) stay
  bounded;
* fan-out — each call's samples are padded to a power-of-two capacity of
  ``128 * ndev``, split into ``ndev`` contiguous pieces, one per device, and
  gathered back in order on the first device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import f64
from repro_torch.core.modal import STREAM_SEGMENT as _SEG
from repro_torch.core.modal import _segment_sums, classify_power
from repro_torch.core.power_model import ChipModel
from repro_torch.power.policies import (EnergyAwarePolicy, NominalPolicy,
                                        PowerCapPolicy,
                                        StaticFrequencyPolicy, decide_batch)
from repro_torch.power.stream import _N_MODES, _contrib

__all__ = ["ShardedExecutor"]

#: the built-in policies whose batched decisions the executor runs
_BUILTINS = (NominalPolicy, StaticFrequencyPolicy, PowerCapPolicy,
             EnergyAwarePolicy)
#: memo key resolutions (keys per watt), tried in turn
_MEMO_SCALES = (10.0, 100.0)
#: memo keys must lie in [0, _MEMO_KEYS)
_MEMO_KEYS = 1 << 22
#: the memo's tables: one row per key
_MEMO_TABLES = (("have", torch.bool), ("val", torch.float64),
                ("im", torch.int64), ("be", torch.float64),
                ("bb", torch.float64), ("bt", torch.float64),
                ("bm", torch.int64))
#: dedup="auto" leaves shards smaller than this to the decision body
_DEDUP_MIN = 4096

Decisions = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _devices(devices) -> List[torch.device]:
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "ShardedExecutor: no CUDA device is visible, and the "
                "executor does not fall back to the CPU; pass "
                "devices=['cpu'] to run it on the host")
        return [torch.device("cuda", i) for i in range(n)]
    if isinstance(devices, int):
        avail = torch.cuda.device_count()
        if devices > avail:
            raise ValueError(
                f"asked for {devices} CUDA devices but only {avail} "
                f"present; pass an explicit device list (e.g. "
                f"devices=['cpu'] * {devices}) to split over the host")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        return [torch.device("cuda", i) for i in range(devices)]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices is an empty sequence")
    return out


def _pad(x, cap: int, value: float):
    """A per-sample tensor padded with ``value`` to ``cap``; a python
    scalar as it is."""
    if not isinstance(x, torch.Tensor) or x.numel() == cap:
        return x
    return torch.cat([x, x.new_full((cap - x.numel(),), value)])


def _piece(x, start: int, size: int, dev: torch.device):
    if not isinstance(x, torch.Tensor):
        return x
    return x[start:start + size].to(dev)


class ShardedExecutor:
    """Executor of the streaming replay / decompose hot path over devices.

    Parameters
    ----------
    devices:
        ``None`` (every visible CUDA device), an int (the first N CUDA
        devices; more than exist raises ``ValueError``), or an explicit
        sequence of ``torch.device``\\ s or strings (``["cpu"]`` runs on the
        host, ``["cpu"] * 8`` splits it eight ways). With no CUDA device,
        ``None`` raises: the executor never falls back to the CPU. Give
        devices of one kind: the card and the host may differ by an ulp.
    chunk:
        Samples per call of the decision body; larger shards (and larger
        unique sets) run in ``chunk``-sized calls, so temporaries stay
        bounded.
    dedup:
        ``"auto"`` (default) collapses a shard to its unique ``(power,
        mode)`` pairs when that pays (4096 samples or more, at most half of
        them unique); ``True`` always tries, ``False`` never. Exact either
        way.
    isa:
        Kept for the reference's signature; it changes nothing. The
        reference compiles its body for AVX so that no ``a*b+c`` contracts
        into an FMA; eager torch ops never contract.
    """

    def __init__(self, devices=None, *, chunk: int = 65536,
                 dedup="auto", isa: Optional[str] = "AVX"):
        self.devices = _devices(devices)
        self.ndev = len(self.devices)
        self.chunk = int(chunk)
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.dedup = dedup
        self.isa = isa
        self._memo: Dict[tuple, object] = {}
        self.stats = {"kernel_calls": 0, "samples": 0, "dedup_samples": 0,
                      "compiles": 0, "memo_hits": 0}

    def __repr__(self) -> str:
        return (f"ShardedExecutor(ndev={self.ndev}, chunk={self.chunk}, "
                f"dedup={self.dedup!r}, isa={self.isa!r})")

    # --------------------------------------------------------------- policy
    def supports(self, policy) -> bool:
        """True when ``policy`` is one of the four built-ins. Other
        policies make :func:`repro_torch.power.stream.replay` take its plain
        path on the shard's device (same results, one call a shard)."""
        return type(policy) in _BUILTINS

    # ----------------------------------------------------------- public API
    def decide_shard(self, policy, model: ChipModel, rec_model: ChipModel,
                     power_w, mode_idx, duration_s, freq_frac,
                     modes_from_power: bool = False,
                     return_modes: bool = False):
        """Replay's per-shard decision pass: invert ``rec_model``'s power
        model into roofline profiles and evaluate ``policy`` on ``model``.
        Returns ``(energy_j, baseline_energy_j, time_s, mode_idx)`` tensors
        on the first device, bit for bit equal to
        ``rec_model.surface(dev).infer_profiles(...)`` +
        ``decide_batch(...)`` there.

        ``mode_idx=None`` band-classifies ``power_w`` against ``rec_model``
        here (on the unique values only, where dedup applies);
        ``return_modes=True`` appends the modes used to the tuple, so that
        ``replay``'s recorded fold does not classify again."""
        if not self.supports(policy):
            raise TypeError(
                f"unsupported policy {type(policy).__name__}; check "
                f"supports() before calling decide_shard")
        dev = self.devices[0]
        p = f64(power_w, dev).reshape(-1)
        m = None if mode_idx is None else torch.as_tensor(
            mode_idx, device=dev).to(torch.int64).reshape(-1)
        if m is None:
            modes_from_power = True
        n = p.numel()
        dur = f64(duration_s, dev)
        dur = dur.expand(n) if dur.ndim == 0 else dur.reshape(-1)
        f_scalar = np.ndim(freq_frac) == 0
        fr = float(freq_frac) if f_scalar \
            else f64(freq_frac, dev).reshape(-1)
        self.stats["samples"] += n

        if n and f_scalar and self.dedup in ("auto", True):
            uniform, d0 = torch.stack(
                [(dur == dur[0]).all().to(torch.float64), dur[0]]).tolist()
            if uniform:
                # across shards: warm shards are table gathers only
                out = self._memo_decide(policy, model, rec_model, p, m, d0,
                                        fr, modes_from_power)
                if out is None:
                    # within the shard: its unique (power, mode) pairs
                    out = self._unique_decide(policy, model, rec_model, p,
                                              m, d0, fr, modes_from_power)
                if out is not None:
                    return out if return_modes else out[:4]

        if m is None:
            m = classify_power(p, rec_model.spec).to(torch.int64)
        out = self._run_decide(policy, model, rec_model, p, m, dur, fr)
        return out + (m,) if return_modes else out

    def segment_sums(self, power_w, modes) -> torch.Tensor:
        """The streaming decomposition's inner reduction over the devices:
        per-mode masked power sums (and the all-samples total row) over
        each 128-sample segment, ``(modes + 1, n // 128)`` on the first
        device, each segment bit for bit the stream's own
        ``_segment_sums``. ``power_w`` must be segment-aligned (callers
        buffer, as ``_ModalAcc`` does)."""
        dev = self.devices[0]
        p = f64(power_w, dev).reshape(-1)
        m = torch.as_tensor(modes, device=dev).to(torch.int64).reshape(-1)
        nseg = p.numel() // _SEG
        if nseg * _SEG != p.numel():
            raise ValueError(f"segment_sums needs a multiple of {_SEG} "
                             f"samples, got {p.numel()}")
        per = -(-nseg // self.ndev) * _SEG          # samples a device
        cap = per * self.ndev
        p, m = _pad(p, cap, 0.0), _pad(m, cap, 0)
        outs = []
        for i, d in enumerate(self.devices):
            pp, mm = _piece(p, i * per, per, d), _piece(m, i * per, per, d)
            outs.append(_segment_sums(_contrib(pp, mm).reshape(
                _N_MODES + 1, -1, _SEG)).to(dev))
        self.stats["kernel_calls"] += 1
        out = outs[0] if self.ndev == 1 else torch.cat(outs, dim=1)
        return out[:, :nseg]

    # --------------------------------------------------- decision fast paths
    def _unique_decide(self, policy, model, rec_model, p, m, d0, fr,
                       modes_from_power):
        n = p.numel()
        if self.dedup == "auto" and n < _DEDUP_MIN:
            return None
        if modes_from_power:
            uq, inv = torch.unique(p, return_inverse=True)
            um = classify_power(uq, rec_model.spec).to(torch.int64)
        else:
            # unique rows of (power, mode): the order does not matter, the
            # decisions come back through the inverse
            pairs, inv = torch.unique(
                torch.stack([p, m.to(torch.float64)], dim=1), dim=0,
                return_inverse=True)
            uq, um = pairs[:, 0].contiguous(), pairs[:, 1].to(torch.int64)
        if self.dedup == "auto" and uq.numel() > n // 2:
            return None                     # not enough repetition to pay
        self.stats["dedup_samples"] += n
        be, bb, bt, bm = self._run_decide(policy, model, rec_model, uq, um,
                                          d0, fr)
        modes = m if m is not None else um[inv]
        return be[inv], bb[inv], bt[inv], bm[inv], modes

    def _memo_decide(self, policy, model, rec_model, p, m, d0, fr,
                     modes_from_power):
        """Quantized-telemetry fast path: the decisions are elementwise in
        ``(power, mode)`` and value-deterministic on one device, so they
        memoize across shards. Powers map to integer keys at 0.1 W (then
        0.01 W) resolution, and a shard runs the decision body only for
        keys never seen under this signature (policy, chips, duration,
        frequency, modes' source, devices). Exactness is checked, not
        assumed: a key that two distinct powers share turns the memo off
        for the signature for good, and the caller falls back."""
        sig = (type(policy).__name__, policy, rec_model.spec, model.spec,
               d0, fr, modes_from_power, tuple(self.devices))
        ent = self._memo.get(sig, None)
        if ent is False:
            return None                     # collided before: fallback
        # one copy to the host for every range test of this shard
        ext = [p.min(), p.max()]
        if m is not None:
            ext += [m.min().to(torch.float64), m.max().to(torch.float64)]
        ext = torch.stack(ext).tolist()
        p_lo, p_hi = ext[:2]
        if m is not None and (ext[2] < 0 or ext[3] >= 8):
            return None
        finite = math.isfinite(p_lo) and math.isfinite(p_hi)
        for scale in _MEMO_SCALES:
            if ent is not None and ent["scale"] != scale:
                continue
            # rounding is monotone, so the keys' range is the rounded
            # range of the powers; NaN and inf keep the memo out
            kmax = round(p_hi * scale) if finite else _MEMO_KEYS
            if m is not None:
                kmax = kmax * 8 + int(ext[3])
            if not finite or round(p_lo * scale) < 0 \
                    or kmax >= _MEMO_KEYS:
                ent = None
                continue
            k = torch.round(p * scale).to(torch.int64)
            if m is not None:
                k = k * 8 + m               # (power, mode) compound key
            if ent is None:
                ent = {"scale": scale, "size": 0}
                self._memo[sig] = ent
            out = self._memo_run(ent, policy, model, rec_model, p, m, k,
                                 kmax, d0, fr, modes_from_power)
            if out is not None:
                return out
            self._memo[sig] = ent = None    # collision at this scale
        if ent is None:
            self._memo[sig] = False
        return None

    def _memo_run(self, ent, policy, model, rec_model, p, m, k, kmax, d0,
                  fr, modes_from_power):
        dev = self.devices[0]
        if kmax >= ent["size"]:
            grow = max(kmax + 1, 2 * ent["size"])
            for name, dt in _MEMO_TABLES:
                new = torch.zeros(grow, dtype=dt, device=dev)
                if ent["size"]:
                    new[:ent["size"]] = ent[name]
                ent[name] = new
            ent["size"] = grow
        have = ent["have"][k]
        seen_differs, any_fresh = torch.stack(
            [(have & (ent["val"][k] != p)).any(), (~have).any()]).tolist()
        if seen_differs:
            return None                     # bucket collision: bail out
        if any_fresh:
            fresh = ~have
            kf, pf = k[fresh], p[fresh]
            val = ent["val"]                # scratch scatter, then verify:
            val[kf] = pf                    # with repeated keys any write
            if not bool((val[kf] == pf).all() & (val[k] == p).all()):
                return None                 # may win, so every sample is
            uqk = torch.unique(kf)          # compared
            uq = val[uqk]
            if modes_from_power:
                um = classify_power(uq, rec_model.spec).to(torch.int64)
            else:
                ent["im"][kf] = m[fresh]
                um = ent["im"][uqk]
            be, bb, bt, bm = self._run_decide(policy, model, rec_model, uq,
                                              um, d0, fr)
            for name, x in (("im", um), ("be", be), ("bb", bb), ("bt", bt),
                            ("bm", bm)):
                ent[name][uqk] = x
            ent["have"][uqk] = True
        else:
            self.stats["memo_hits"] += 1
        self.stats["dedup_samples"] += p.numel()
        modes = m if m is not None else ent["im"][k]
        return (ent["be"][k], ent["bb"][k], ent["bt"][k], ent["bm"][k],
                modes)

    # --------------------------------------------------------- the body
    def _capacity(self, n: int) -> int:
        cap = _SEG * self.ndev
        while cap < n:
            cap *= 2
        return cap

    def _run_decide(self, policy, model, rec_model, p, m, dur,
                    fr) -> Decisions:
        """The decision body on ``p`` / ``m`` (``dur`` / ``fr``: python
        floats, or per-sample tensors), ``chunk`` samples a call; each call
        is padded to its capacity, split over the devices and gathered back
        in order on the first."""
        dev = self.devices[0]
        n = p.numel()
        idle = rec_model.spec.idle_w
        outs = []
        for a in range(0, max(n, 1), self.chunk):
            b = min(a + self.chunk, n)
            cap = self._capacity(b - a)
            cols = [_pad(p[a:b], cap, idle), _pad(m[a:b], cap, 1)]
            cols += [_pad(x[a:b], cap, 1.0) if isinstance(x, torch.Tensor)
                     else x for x in (dur, fr)]
            size = cap // self.ndev
            res = [self._decide(policy, model, rec_model, d,
                                *(_piece(x, i * size, size, d)
                                  for x in cols))
                   for i, d in enumerate(self.devices)]
            self.stats["kernel_calls"] += 1
            got = [res[0][j] if self.ndev == 1 else
                   torch.cat([r[j].to(dev) for r in res]) for j in range(4)]
            outs.append([x[:b - a] for x in got])
        if len(outs) == 1:
            return tuple(outs[0])
        return tuple(torch.cat([o[j] for o in outs]) for j in range(4))

    @staticmethod
    def _decide(policy, model, rec_model, dev, p, m, dur, fr) -> Decisions:
        """The port's plain replay path on one device's piece."""
        profiles = rec_model.surface(dev).infer_profiles(
            p, freq_frac=fr, duration_s=dur, mode_idx=m)
        bd = decide_batch(policy, profiles, model, device=dev)
        return bd.energy_j, bd.baseline_energy_j, bd.time_s, bd.mode_idx
