"""Online fleet power broker: event-driven cluster simulation with
budgeted cap allocation (the paper's offline schedule taken online).

The paper's 8.5% / 1438 MWh headline is an *offline upper bound*: it
assumes every job's full trace is known before any cap is chosen. The
online setting (Eco-Mode, arXiv:2404.03271) has jobs arrive over time, a
facility hold one global power budget, and a broker split it across the
running mix in real time, knowing only what each job has shown so far.
This module is that setting as a discrete-event simulation:

* :class:`ClusterTrace` — the columnar workload: per-job arrival /
  walltime / node columns plus per-chunk modal summaries (mean power,
  dominant mode, C.I.-hours fraction, cumulative modal energies) as
  tensors on one device, built from a :class:`~repro_torch.power.jobs.
  JobTable` (:meth:`ClusterTrace.from_jobs`, a tensor pass on the table's
  device), folded shard-by-shard from a telemetry stream
  (:meth:`ClusterTrace.from_stream`) or synthesized at 50k-job scale
  (:meth:`ClusterTrace.synthetic`, numpy's draws on the host);
* :func:`simulate_cluster` — the event loop: an arrival queue with FCFS +
  EASY-backfill placement over an ``n_nodes`` pool, job start/end/
  telemetry-chunk events on a heap, and at every chunk event ONE batched
  :class:`~repro_torch.power.surface.TransferSurface` pass over all
  running jobs on the trace's device handed to the broker;
* broker policies — :class:`UniformBroker`, :class:`GreedyValueBroker`,
  :class:`ClassScheduleBroker`, :class:`OracleBroker` (the offline bound:
  :func:`~repro_torch.power.jobs.class_cap_report` on the full trace) and
  :class:`PolicyBroker` (any power policy through ``decide_batch``);
* :class:`BrokerReport` — throughput next to projected energy savings.

Where the work runs: the event heap, the FCFS queue, EASY backfill and the
per-job scalars that admission, completion and scoring read are host
Python and numpy, as in the reference — one scalar at a time, which on the
device would cost a synchronisation each. The menu-wide columns and, at
every tick, the view's model pass and the broker's ``(running, menu)``
arithmetic run on the trace's device; the tick's choices come back to the
host in one copy. Sums and prefix sums whose order decides a discrete
choice (the budget excess, the shed prefix of the greedy pass, the class
aggregates of the schedule broker, the cumulative energy curves, the
score bins) are taken in numpy's order, so every choice equals the
reference's.

Budget semantics: the broker allocates *watts of predicted draw* per job;
the simulator enforces that the summed allocation never exceeds the
facility budget at any event (allocations are proportionally clamped if a
broker overshoots; :class:`OracleBroker` is ``offline`` and exempt).
Savings/dT are scored with the projection response tables (``kind=
"power"`` by default), the estimator of the offline schedule; the per-tick
model pass drives *ranking*.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, as_device, f64
from repro_torch.core.hardware import ChipSpec, MI250X_GCD
from repro_torch.core.modal import (BatchModalDecomposition, MODES,
                                    classify_power)
from repro_torch.core.power_model import ChipModel
from repro_torch.core.projection import (DT_WEIGHT_PER_CI_HOUR,
                                         builtin_tables,
                                         interp_response_batch,
                                         project_batch)
from repro_torch.power.jobs import (COMPUTE_INTENSIVE,  # noqa: F401
                                    DT0_TOL_PCT, FleetJobsReport,
                                    JOB_CLASSES, LATENCY_BOUND,
                                    MEMORY_INTENSIVE, _MODE_TO_CLASS,
                                    class_cap_report, classify_jobs,
                                    default_caps)
from repro_torch.power.objectives import get_objective
from repro_torch.power.policies import decide_batch
from repro_torch.power.surface import ProfileArray

_N_MODES = len(MODES)
_J_TO_MWH = 1.0 / 3.6e9                  # W*s -> MWh
_EPS = 1e-9
_F64 = torch.float64


def _np_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's order: its pairwise summation
    (sequential from 0 under 8 elements, eight running sums and a fixed
    tree up to 128, halves beyond), so a reduction numpy takes over a
    contiguous row gives the same bits on every device."""
    n = x.shape[-1]
    if n < 8:
        res = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[..., i]
        return res
    if n <= 128:
        r = x[..., 0:8]
        m = n - n % 8
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) \
            + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            res = res + x[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _np_sum(x[..., :n2]) + _np_sum(x[..., n2:])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# ClusterTrace: the columnar workload the event loop consumes
# ---------------------------------------------------------------------------
@dataclass
class ClusterTrace:
    """Per-job schedule columns + per-chunk modal summaries, as tensors on
    one device.

    A "chunk" is ``chunk_samples`` consecutive telemetry samples of one
    job (its last chunk may be shorter) — the granularity at which the
    online broker observes jobs and reallocates. All columns are dense
    ``(jobs,)`` / ``(jobs, max_chunks)`` tensors; cumulative columns
    (``cum_*``, shape ``(jobs, max_chunks + 1)``) give piecewise-linear
    energy-vs-nominal-progress curves the simulator gathers from, so the
    event loop never touches per-sample data.
    """

    chip: ChipSpec
    sample_interval_s: float
    chunk_samples: int
    job_ids: List[str]
    arrival_s: torch.Tensor              # (J,) submission times
    walltime_s: torch.Tensor             # (J,) nominal (uncapped) runtimes
    nodes: torch.Tensor                  # (J,) node counts
    n_chunks: torch.Tensor               # (J,) valid chunks per job
    chunk_power_w: torch.Tensor          # (J,K) job draw W per chunk
    chunk_unit_power_w: torch.Tensor     # (J,K) per-GCD mean W (profiles)
    chunk_mode: torch.Tensor             # (J,K) dominant mode idx (0 pad)
    chunk_ci_frac: torch.Tensor          # (J,K) C.I.-hours fraction
    chunk_dur_s: torch.Tensor            # (J,K) nominal seconds per chunk
    cum_e_ci: torch.Tensor               # (J,K+1) cumulative mode-3 MWh
    cum_e_mi: torch.Tensor               # (J,K+1) cumulative mode-2 MWh
    cum_e_m1: torch.Tensor               # (J,K+1) cumulative mode-1 MWh
    cum_e_tot: torch.Tensor              # (J,K+1) cumulative total MWh
    cum_ci_s: torch.Tensor               # (J,K+1) cumulative C.I. seconds
    decomp: BatchModalDecomposition      # full-trace modal decomposition

    @property
    def n_jobs(self) -> int:
        return int(self.arrival_s.numel())

    @property
    def device(self) -> torch.device:
        return self.arrival_s.device

    @property
    def chunk_s(self) -> float:
        """Nominal duration of a full chunk (the realloc cadence)."""
        return self.chunk_samples * self.sample_interval_s

    @property
    def total_energy_mwh(self) -> float:
        return float(_host(self.decomp.total_energy_mwh).sum())

    def classes(self) -> torch.Tensor:
        """Full-trace class index per job (the oracle's knowledge)."""
        return classify_jobs(self.decomp)

    # ------------------------------------------------------------ builders
    @staticmethod
    def _finish(chip, interval, cs, job_ids, arrival, walltime, nodes,
                n_chunks, power, unit_power, mode, ci_frac, dur, e_by_mode,
                decomp) -> "ClusterTrace":
        """Shared tail of every constructor: cumulative curves from the
        per-chunk per-mode energy stack ``e_by_mode`` (J, K, modes), each
        a sequential prefix sum on the host (numpy's ``cumsum``), copied
        back to the columns' device."""
        dev = power.device

        def cum(x):
            h = _host(x)
            out = np.zeros((h.shape[0], h.shape[1] + 1), dtype=np.float64)
            np.cumsum(h, axis=1, out=out[:, 1:])
            return torch.from_numpy(out).to(dev)
        e_tot = _np_sum(e_by_mode)
        return ClusterTrace(
            chip=chip, sample_interval_s=float(interval),
            chunk_samples=int(cs), job_ids=list(job_ids),
            arrival_s=f64(arrival, dev), walltime_s=f64(walltime, dev),
            nodes=torch.as_tensor(nodes, dtype=torch.int64, device=dev),
            n_chunks=torch.as_tensor(n_chunks, dtype=torch.int64,
                                     device=dev),
            chunk_power_w=power, chunk_unit_power_w=unit_power,
            chunk_mode=mode, chunk_ci_frac=ci_frac,
            chunk_dur_s=dur,
            cum_e_ci=cum(e_by_mode[:, :, 2]),
            cum_e_mi=cum(e_by_mode[:, :, 1]),
            cum_e_m1=cum(e_by_mode[:, :, 0]),
            cum_e_tot=cum(e_tot), cum_ci_s=cum(ci_frac * dur),
            decomp=decomp)

    @classmethod
    def from_jobs(cls, table, chunk_samples: int = 60,
                  node_weighted: bool = True) -> "ClusterTrace":
        """Chunk-fold a :class:`~repro_torch.power.jobs.JobTable` on its
        device, in one tensor pass (chunk sums in numpy's order).

        ``node_weighted=True`` (default) treats each trace as the
        *per-GCD* power signal and scales a job's draw and energy by its
        node count — at 10k-node scale this is what makes facility
        budgets genuinely megawatt-sized. The stored ``decomp`` is the
        table's ``decompose()`` scaled the same way, and
        :class:`OracleBroker` on this trace reproduces
        ``class_cap_report(trace.decomp, ...)`` exactly; with
        ``node_weighted=False`` the decomp is ``table.decompose()``
        bit-for-bit."""
        if chunk_samples < 1:
            raise ValueError(f"chunk_samples must be >= 1, got "
                             f"{chunk_samples}")
        chip, interval = table.chip, float(table.sample_interval_s)
        powers, mask = table.powers, table.mask
        j_n, width = powers.shape
        modes = classify_power(powers, chip)
        modes = torch.where(mask, modes, torch.zeros_like(modes))
        k = -(-width // chunk_samples)
        pad = k * chunk_samples - width
        if pad:
            powers = torch.nn.functional.pad(powers, (0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
            modes = torch.nn.functional.pad(modes, (0, pad))
        pw = powers.reshape(j_n, k, chunk_samples)
        mk = mask.reshape(j_n, k, chunk_samples)
        md = modes.reshape(j_n, k, chunk_samples)
        cnt = mk.sum(dim=2)
        e_sample = pw * mk * (interval * _J_TO_MWH)
        e_by_mode = torch.stack(
            [_np_sum(e_sample * (md == m.idx)) for m in MODES], dim=2)
        cnt_by_mode = torch.stack(
            [(mk & (md == m.idx)).sum(dim=2) for m in MODES], dim=2)
        safe = torch.clamp(cnt, min=1).to(_F64)
        mean_p = _np_sum(pw * mk) / safe
        dom = torch.where(
            cnt > 0, torch.argmax(e_by_mode, dim=2).to(torch.int32) + 1,
            torch.zeros((), dtype=torch.int32, device=pw.device))
        ci_frac = (cnt_by_mode[:, :, 2] + cnt_by_mode[:, :, 3]).to(_F64) \
            / safe
        decomp = table.decompose()
        job_p = mean_p
        if node_weighted:
            w = table.nodes.to(_F64)
            job_p = mean_p * w[:, None]
            e_by_mode = e_by_mode * w[:, None, None]
            decomp = BatchModalDecomposition(
                hours_pct=decomp.hours_pct,
                energy_mwh=decomp.energy_mwh * w[:, None],
                total_energy_mwh=decomp.total_energy_mwh * w,
                sample_interval_s=decomp.sample_interval_s,
                n_samples=decomp.n_samples)
        return cls._finish(
            chip, interval, chunk_samples, table.job_ids,
            table.arrival_s, table.walltime_s, table.nodes,
            -(-table.lengths // chunk_samples), job_p, mean_p, dom, ci_frac,
            cnt.to(_F64) * interval, e_by_mode, decomp)

    @classmethod
    def from_stream(cls, stream: Iterable, chip: ChipSpec = MI250X_GCD,
                    sample_interval_s: float = 15.0,
                    chunk_samples: int = 60, device=None) -> "ClusterTrace":
        """Fold a shard stream (``JobTable.to_stream()``, JSONL, npz
        spills) into the same chunk summaries with O(jobs x chunks)
        memory — per-sample data is reduced shard by shard, never held.
        Arrivals come from the shards' ``time_s`` stamps when present
        (first stamp per job), else every job arrives at t=0. Each shard is
        classified on its device and copied to the host once; the per-job
        chunk bookkeeping is the reference's, in numpy; the columns land on
        the shards' device (``device`` places array shards)."""
        from repro_torch.power.stream import SampleShard
        if chunk_samples < 1:
            raise ValueError(f"chunk_samples must be >= 1, got "
                             f"{chunk_samples}")
        interval = float(sample_interval_s)
        done: Dict[str, List] = {}
        rest: Dict[str, List[np.ndarray]] = {}
        arrive: Dict[str, float] = {}
        order: List[str] = []
        dev = None

        def reduce_job(jid, p, e, m, d):
            buf = rest.get(jid)
            if buf is not None:
                p = np.concatenate([buf[0], p])
                e = np.concatenate([buf[1], e])
                m = np.concatenate([buf[2], m])
                d = np.concatenate([buf[3], d])
            k_full = p.size // chunk_samples
            if k_full:
                n = k_full * chunk_samples
                rows = done.setdefault(jid, [])
                pm = p[:n].reshape(k_full, chunk_samples)
                em = e[:n].reshape(k_full, chunk_samples)
                mm = m[:n].reshape(k_full, chunk_samples)
                dm = d[:n].reshape(k_full, chunk_samples)
                e_modes = np.stack(
                    [np.where(mm == md.idx, em, 0.0).sum(axis=1)
                     for md in MODES], axis=1)
                c_modes = np.stack([(mm == md.idx).sum(axis=1)
                                    for md in MODES], axis=1)
                for i in range(k_full):
                    rows.append((dm[i].sum(), (pm[i] * dm[i]).sum(),
                                 e_modes[i], c_modes[i]))
                p, e, m, d = p[n:], e[n:], m[n:], d[n:]
            if p.size:
                rest[jid] = [p.copy(), e.copy(), m.copy(), d.copy()]
            elif jid in rest:
                del rest[jid]

        for shard in stream:
            sh = SampleShard.coerce(shard, interval, device)
            if len(sh) == 0:
                continue
            dev = sh.device
            modes = _host(sh.mode if sh.mode is not None
                          else classify_power(sh.power_w, chip))
            p_h, d_h = _host(sh.power_w), _host(sh.duration_s)
            e_mwh = _host(sh.energy_j) * _J_TO_MWH
            t_h = None if sh.time_s is None else _host(sh.time_s)
            jids = sh.job_id
            uniq, first = np.unique(jids, return_index=True)
            for u, f0 in sorted(zip(uniq, first), key=lambda t: t[1]):
                jid = str(u)
                if jid not in arrive:
                    order.append(jid)
                    arrive[jid] = float(t_h[f0]) if t_h is not None else 0.0
                sel = jids == u
                reduce_job(jid, p_h[sel], e_mwh[sel], modes[sel], d_h[sel])
        for jid, buf in list(rest.items()):
            p, e, m, d = buf
            rows = done.setdefault(jid, [])
            e_modes = np.stack([np.where(m == md.idx, e, 0.0).sum()
                                for md in MODES])
            c_modes = np.array([(m == md.idx).sum() for md in MODES])
            rows.append((d.sum(), (p * d).sum(), e_modes, c_modes))
        rest.clear()
        if not order:
            raise ValueError("empty stream: no samples to build a "
                             "ClusterTrace from")

        j_n = len(order)
        n_chunks = np.array([len(done[j]) for j in order], dtype=np.int64)
        k = int(n_chunks.max())
        dur = np.zeros((j_n, k))
        psum = np.zeros((j_n, k))
        e_by_mode = np.zeros((j_n, k, _N_MODES))
        c_by_mode = np.zeros((j_n, k, _N_MODES), dtype=np.int64)
        for j, jid in enumerate(order):
            for i, (d_i, ps_i, em_i, cm_i) in enumerate(done[jid]):
                dur[j, i] = d_i
                psum[j, i] = ps_i
                e_by_mode[j, i] = em_i
                c_by_mode[j, i] = cm_i
        cnt = c_by_mode.sum(axis=2)
        mean_p = psum / np.maximum(dur, 1e-12)
        dom = np.where(cnt > 0,
                       np.argmax(e_by_mode, axis=2).astype(np.int32) + 1, 0)
        ci_frac = (c_by_mode[:, :, 2] + c_by_mode[:, :, 3]) \
            / np.maximum(cnt, 1)
        tot_cnt = cnt.sum(axis=1)
        e_job = e_by_mode.sum(axis=1)                       # (J, modes)

        def t(x, dtype=_F64):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)
        decomp = BatchModalDecomposition(
            hours_pct=t(100.0 * c_by_mode.sum(axis=1)
                        / np.maximum(tot_cnt, 1)[:, None]),
            energy_mwh=t(e_job),
            total_energy_mwh=t(e_job.sum(axis=1)),
            sample_interval_s=interval,
            n_samples=t(tot_cnt, torch.int64))
        # streams carry no node counts: every job is 1 node, so weighted
        # and unweighted coincide (unit power == job power)
        return cls._finish(
            chip, interval, chunk_samples, order,
            t(np.array([arrive[j] for j in order])), t(dur.sum(axis=1)),
            t(np.ones(j_n), torch.int64), t(n_chunks, torch.int64),
            t(mean_p), t(mean_p), t(dom, torch.int32), t(ci_frac), t(dur),
            t(e_by_mode), decomp)

    @classmethod
    def synthetic(cls, n_jobs: int, seed: int = 0,
                  chip: ChipSpec = MI250X_GCD,
                  sample_interval_s: float = 15.0,
                  chunk_samples: int = 60,
                  mean_samples: int = 120, max_samples: int = 360,
                  arrival_gap_s: float = 60.0,
                  class_mix: Optional[Dict[str, float]] = None,
                  walltime_sigma: float = 0.6,
                  node_weighted: bool = True,
                  device=DEFAULT_DEVICE) -> "ClusterTrace":
        """Synthetic workload at cluster scale: the same class mix / power
        bands / size classes / Poisson arrivals / lognormal walltimes as
        :func:`~repro_torch.power.jobs.synth_job_traces`, sampled directly
        at chunk granularity. Drawn on the host from
        ``np.random.default_rng(seed)`` in the reference's order (so the
        columns are the reference's bit for bit), then placed on
        ``device``. Power bands are per-GCD; ``node_weighted`` (default)
        scales each job's draw and energy by its node count, putting
        facility draw at MW scale."""
        from repro_torch.core.hardware import JOB_SIZE_CLASSES
        from repro_torch.power.jobs import (CLASS_MIX, _MAIN_POWER_W,
                                            _SETUP_POWER_W, _SIZE_CLASS_P)
        rng = np.random.default_rng(seed)
        mix = class_mix or CLASS_MIX
        names = list(mix)
        p_cls = np.array([mix[c] for c in names], dtype=np.float64)
        cls_idx = rng.choice(len(names), size=n_jobs, p=p_cls / p_cls.sum())
        sizes = list(_SIZE_CLASS_P)
        p_sz = np.array([_SIZE_CLASS_P[s] for s in sizes])
        sz = rng.choice(len(sizes), size=n_jobs, p=p_sz / p_sz.sum())
        lo = np.array([JOB_SIZE_CLASSES[s][0] for s in sizes])[sz]
        hi = np.array([JOB_SIZE_CLASSES[s][1] for s in sizes])[sz]
        nodes = rng.integers(lo, hi + 1)
        n_samp = np.clip(rng.lognormal(np.log(mean_samples), walltime_sigma,
                                       size=n_jobs), 6,
                         max_samples).astype(np.int64)
        arrival = np.cumsum(rng.exponential(arrival_gap_s, size=n_jobs))
        walltime = n_samp.astype(np.float64) * sample_interval_s
        n_chunks = -(-n_samp // chunk_samples)
        k = int(n_chunks.max())
        mu = np.array([_MAIN_POWER_W[c][0] for c in names])[cls_idx]
        sd = np.array([_MAIN_POWER_W[c][1] for c in names])[cls_idx]
        target = rng.normal(mu, sd)
        power = target[:, None] + rng.normal(0.0, 6.0, size=(n_jobs, k))
        # startup/teardown bookend: first chunk of multi-chunk jobs runs
        # the low-power setup phase
        setup = rng.normal(_SETUP_POWER_W[0], _SETUP_POWER_W[1],
                           size=n_jobs)
        multi = n_chunks > 1
        power[multi, 0] = np.clip(setup[multi], chip.idle_w * 0.98, 199.0)
        power = np.clip(power, chip.idle_w * 0.98, chip.tdp_w)
        valid = np.arange(k)[None, :] < n_chunks[:, None]
        power = np.where(valid, power, 0.0)
        mode = np.where(valid, _host(classify_power(
            torch.from_numpy(np.maximum(power, 1.0)), chip)),
            0).astype(np.int32)
        full_s = chunk_samples * sample_interval_s
        dur = np.clip(walltime[:, None] - np.arange(k)[None, :] * full_s,
                      0.0, full_s)
        ci_frac = ((mode == 3) | (mode == 4)).astype(np.float64)
        unit_power = power
        job_power = power * nodes[:, None] if node_weighted else power
        e_tot = job_power * dur * _J_TO_MWH
        e_by_mode = np.stack([np.where(mode == m.idx, e_tot, 0.0)
                              for m in MODES], axis=2)
        cnt_modes = np.stack(
            [np.where(mode == m.idx, dur / sample_interval_s, 0.0)
             .sum(axis=1) for m in MODES], axis=1)
        dev = as_device(device)

        def t(x, dtype=_F64):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)
        decomp = BatchModalDecomposition(
            hours_pct=t(100.0 * cnt_modes
                        / np.maximum(cnt_modes.sum(axis=1), 1e-12)[:, None]),
            energy_mwh=t(e_by_mode.sum(axis=1)),
            total_energy_mwh=t(e_tot.sum(axis=1)),
            sample_interval_s=sample_interval_s,
            n_samples=t(n_samp, torch.int64))
        return cls._finish(
            chip, sample_interval_s, chunk_samples,
            [f"job{j:06d}" for j in range(n_jobs)], t(arrival), t(walltime),
            t(nodes, torch.int64), t(n_chunks, torch.int64), t(job_power),
            t(unit_power), t(mode, torch.int32), t(ci_frac), t(dur),
            t(e_by_mode), decomp)


# ---------------------------------------------------------------------------
# Broker protocol + implementations
# ---------------------------------------------------------------------------
@dataclass
class BrokerView:
    """What a broker sees at one reallocation event: columnar state of
    the running set plus the menu-wide model evaluation (one batched
    ``TransferSurface`` pass, shared by every broker), as tensors on the
    trace's device. ``menu_caps[0]`` is ``inf`` (uncapped); deeper entries
    are the cap grid in falling order, so ``draw_w`` / ``model_*``
    columns are menu-aligned."""

    now_s: float
    budget_w: float
    n_nodes: int
    free_nodes: int
    kind: str
    menu_caps: np.ndarray                # (C,) inf first, host
    tables: object                       # ResponseTables driving scoring
    chip: ChipModel
    sample_interval_s: float
    job_idx: torch.Tensor                # (R,) trace job indices
    nodes: torch.Tensor                  # (R,)
    draw_w: torch.Tensor                 # (R,C) predicted draw per entry
    rt: torch.Tensor                     # (R,C) runtime factors
    profiles: ProfileArray               # (R,) inferred chunk profiles
    model_energy_j: torch.Tensor         # (R,C) model step energy
    model_time_s: torch.Tensor           # (R,C) model step time
    model_power_w: torch.Tensor          # (R,C) model power
    obs_energy_mwh: torch.Tensor         # (R,4) observed per-mode energy
    obs_time_s: torch.Tensor             # (R,) observed nominal seconds
    obs_ci_s: torch.Tensor               # (R,) observed C.I. seconds

    @property
    def n_running(self) -> int:
        return int(self.job_idx.numel())

    @property
    def n_menu(self) -> int:
        return int(self.menu_caps.size)

    @property
    def device(self) -> torch.device:
        return self.draw_w.device


def _first_fit(draw_w, limit_w):
    """Least restrictive menu entry whose predicted draw fits ``limit_w``
    per job (deepest entry when none does). ``draw_w`` falls (weakly)
    along the menu, so the first fit is the first maximum of the fit mask
    (cast to an integer type: ``argmax`` refuses a bool tensor). Host
    arrays take numpy's path."""
    if isinstance(draw_w, np.ndarray):
        fits = draw_w <= limit_w[:, None] * (1.0 + _EPS)
        return np.where(fits.any(axis=1), fits.argmax(axis=1),
                        draw_w.shape[1] - 1)
    fits = draw_w <= limit_w[:, None] * (1.0 + _EPS)
    first = torch.argmax(fits.to(torch.int32), dim=1)
    return torch.where(fits.any(dim=1), first,
                       torch.full_like(first, draw_w.shape[1] - 1))


def _greedy_deepen(draw_w: torch.Tensor, penalty: torch.Tensor,
                   choice: torch.Tensor, budget_w: float) -> torch.Tensor:
    """Shared budget-fit pass: while the chosen draws exceed the budget,
    push jobs to the deepest menu entry in rising penalty-per-watt-shed
    order (one stable argsort on the device; the budget excess and the
    shed prefix sums in numpy's order on the host, so the cut falls where
    the reference's does)."""
    deep = draw_w.shape[1] - 1
    cur = torch.gather(draw_w, 1, choice[:, None])[:, 0]
    over = float(_host(cur).sum()) - budget_w
    if over <= 0.0:
        return choice
    shed = cur - draw_w[:, deep]
    can = shed > _EPS
    pen = penalty[:, deep] - torch.gather(penalty, 1, choice[:, None])[:, 0]
    ratio = torch.where(can, pen / torch.clamp(shed, min=_EPS),
                        torch.full_like(pen, float("inf")))
    order = torch.argsort(ratio, stable=True)
    order = order[can[order]]
    if order.numel() == 0:
        return choice
    csum = np.cumsum(_host(shed[order]))
    take = int(np.searchsorted(csum, over - _EPS) + 1)
    out = choice.clone()
    out[order[:take]] = deep
    return out


class UniformBroker:
    """Split the budget by node share: each running job gets
    ``budget * nodes_j / sum(nodes)`` and takes the least restrictive
    menu entry fitting its share — the no-information baseline."""

    name = "uniform"
    offline = False

    def allocate(self, view: BrokerView) -> torch.Tensor:
        share = view.budget_w * view.nodes.to(_F64) \
            / max(float(view.nodes.sum()), 1.0)
        return _first_fit(view.draw_w, share)


class GreedyValueBroker:
    """Marginal-value ranking on the batched model pass: every job takes
    its model-objective argmin menu entry (within ``slowdown_budget`` of
    the model's uncapped step time), then — under budget pressure — jobs
    are pushed deeper in rising objective-penalty-per-watt-shed order.
    ``objective`` takes any name in the shared registry
    :data:`repro_torch.power.objectives.OBJECTIVES`."""

    offline = False

    def __init__(self, objective: str = "energy",
                 slowdown_budget: float = 0.10):
        self.objective = get_objective(objective).name
        self.slowdown_budget = float(slowdown_budget)
        self.name = "greedy" if self.objective == "energy" \
            else f"greedy-{self.objective}"

    def _objective(self, view: BrokerView) -> torch.Tensor:
        return get_objective(self.objective).score(
            view.model_energy_j, view.model_time_s, view.model_power_w)

    def allocate(self, view: BrokerView) -> torch.Tensor:
        obj = self._objective(view)
        ok = view.model_time_s <= view.model_time_s[:, :1] \
            * (1.0 + self.slowdown_budget) * (1.0 + _EPS)
        ok[:, 0] = True
        masked = torch.where(ok, obj, torch.full_like(obj, float("inf")))
        choice = torch.argmin(masked, dim=1)
        return _greedy_deepen(view.draw_w, obj, choice, view.budget_w)


class ClassScheduleBroker:
    """The paper's per-class cap schedule, applied online: jobs are
    classified from their *observed* chunks (dominant observed mode);
    per-class caps come from a :func:`project_batch` over the observed
    class aggregates under exactly the offline rules (L.B. uncapped, M.I.
    best among dT<=tol, C.I. unconstrained best) where "best" is the cap
    maximizing ``objective``'s metric-equivalent savings. Jobs younger than
    ``warmup_s`` run uncapped. The class aggregates are host sums in
    numpy's order and each class's projection is one host-sized row, with
    numpy's first-maximum rule. Budget pressure falls back to greedy
    deepening by scored savings."""

    offline = False

    def __init__(self, warmup_s: float = 900.0,
                 dt0_tol_pct: float = DT0_TOL_PCT,
                 objective: str = "energy"):
        self.warmup_s = float(warmup_s)
        self.dt0_tol_pct = float(dt0_tol_pct)
        self.objective = get_objective(objective).name
        self.name = "class-schedule" if self.objective == "energy" \
            else f"class-schedule-{self.objective}"

    def allocate(self, view: BrokerView) -> torch.Tensor:
        r = view.n_running
        choice = np.zeros(r, dtype=np.int64)
        obs_t = _host(view.obs_time_s)
        known = obs_t >= self.warmup_s
        if known.any():
            obs_e = _host(view.obs_energy_mwh)
            obs_ci = _host(view.obs_ci_s)
            dom = np.argmax(obs_e, axis=1).astype(np.int32) + 1
            cls = np.asarray(_MODE_TO_CLASS)[dom]
            caps = np.asarray(view.menu_caps[1:], dtype=np.float64)
            obj = get_objective(self.objective)
            for ci, name in enumerate(JOB_CLASSES):
                sel = known & (cls == ci)
                if not sel.any() or name == LATENCY_BOUND:
                    continue
                e_ci = float(obs_e[sel, 2].sum())
                e_mi = float(obs_e[sel, 1].sum())
                e_tot = float(obs_e[sel].sum())
                t_obs = float(obs_t[sel].sum())
                w = DT_WEIGHT_PER_CI_HOUR \
                    * float(obs_ci[sel].sum()) / max(t_obs, 1e-12)
                proj = project_batch(
                    caps, view.kind, e_ci_mwh=[e_ci], e_mi_mwh=[e_mi],
                    e_total_mwh=[max(e_tot, 1e-12)], dt_weight=[w],
                    tables=view.tables, device="cpu")
                sav, dt = proj.savings_pct[0], proj.dt_pct[0]
                val = _host(f64(obj.cap_score(sav, dt,
                                              dt_tol_pct=self.dt0_tol_pct),
                                "cpu"))
                sav, dt = sav.numpy(), dt.numpy()
                if name == MEMORY_INTENSIVE:
                    fit = dt <= self.dt0_tol_pct
                    if not fit.any():
                        continue
                    pick = int(np.argmax(np.where(fit, val, -np.inf)))
                else:                               # compute-intensive
                    if not (val > -np.inf).any():
                        continue
                    pick = int(np.argmax(val))
                choice[sel] = pick + 1              # menu idx 0 = uncapped
        return _greedy_deepen(view.draw_w, view.model_energy_j,
                              torch.from_numpy(choice).to(view.device),
                              view.budget_w)


class OracleBroker:
    """The offline upper bound: full-trace per-class caps from
    :func:`~repro_torch.power.jobs.class_cap_report`, budget ignored
    (``offline=True`` — the simulator neither clamps nor audits it).
    Savings in its :class:`BrokerReport` are copied from the embedded
    schedule report, so they equal the offline aggregates exactly."""

    name = "oracle"
    offline = True

    def __init__(self, dt0_tol_pct: float = DT0_TOL_PCT,
                 objective: str = "energy"):
        self.dt0_tol_pct = float(dt0_tol_pct)
        self.objective = get_objective(objective).name
        if self.objective != "energy":
            self.name = f"oracle-{self.objective}"
        self.schedule: Optional[FleetJobsReport] = None
        self._choice: Optional[torch.Tensor] = None

    def prepare(self, trace: ClusterTrace, menu_caps: np.ndarray,
                kind: str, tables) -> None:
        caps = tuple(float(c) for c in menu_caps[1:])
        self.schedule = class_cap_report(trace.decomp, caps=caps,
                                         kind=kind,
                                         dt0_tol_pct=self.dt0_tol_pct,
                                         tables=tables,
                                         objective=self.objective)
        cap_by_class = {c.job_class: c.cap for c in self.schedule.classes}
        menu_idx = {None: 0}
        menu_idx.update({c: i + 1 for i, c in enumerate(caps)})
        per_class = torch.tensor(
            [menu_idx[cap_by_class.get(name)] for name in JOB_CLASSES],
            dtype=torch.int64, device=trace.device)
        self._choice = per_class[trace.classes().long()]

    def allocate(self, view: BrokerView) -> torch.Tensor:
        return self._choice[view.job_idx]


class PolicyBroker:
    """Lift any :class:`~repro_torch.power.policies.PowerPolicy` into a
    broker: the policy decides a power per running job through the shared
    :func:`~repro_torch.power.policies.decide_batch` helper (so
    third-party scalar-only policies go through the same fallback the
    session and replay use), and each job takes the least restrictive menu
    entry fitting its decided power; the simulator's budget clamp supplies
    the facility invariant."""

    offline = False

    def __init__(self, policy):
        self.policy = policy
        self.name = f"policy:{getattr(policy, 'name', 'custom')}"

    def allocate(self, view: BrokerView) -> torch.Tensor:
        bd = decide_batch(self.policy, view.profiles, view.chip,
                          device=view.device)
        # decisions are per GCD; draw_w is the job's node-scaled draw
        decided = f64(bd.power_w, view.device) * view.nodes.to(_F64)
        choice = _first_fit(view.draw_w, decided)
        return _greedy_deepen(view.draw_w, view.model_energy_j, choice,
                              view.budget_w)


BROKERS: Dict[str, type] = {
    "uniform": UniformBroker,
    "greedy": GreedyValueBroker,
    "class-schedule": ClassScheduleBroker,
    "oracle": OracleBroker,
}

BrokerLike = Union[None, str, object]


def get_broker(spec: BrokerLike = None, **knobs):
    """Resolve a broker: ``None`` -> uniform, a name from
    :data:`BROKERS` (with its knobs), an object with ``allocate``
    passed through, or a :class:`PowerPolicy` wrapped in
    :class:`PolicyBroker`."""
    if spec is None:
        spec = "uniform"
    if isinstance(spec, str):
        try:
            factory = BROKERS[spec]
        except KeyError:
            raise KeyError(f"unknown broker {spec!r}; "
                           f"known: {sorted(BROKERS)}") from None
        return factory(**knobs)
    if hasattr(spec, "allocate"):
        return spec
    if hasattr(spec, "decide"):
        return PolicyBroker(spec)
    raise TypeError(f"cannot resolve a broker from {spec!r}")


# ---------------------------------------------------------------------------
# The event loop
# ---------------------------------------------------------------------------
@dataclass
class BrokerReport:
    """One simulated run: scheduling outcomes next to projected energy.

    Savings are scored with the offline estimator (response tables over
    the per-cap energy bins the run actually consumed), so an online
    broker's ``savings_mwh`` is directly comparable to the
    ``class_cap_report`` bound; ``peak_alloc_w`` / ``budget_exceeded``
    audit the facility invariant (``offline`` runs skip it). ``n_ticks``
    counts the reallocation events (this package's addition)."""

    broker: str
    kind: str
    chip: str
    budget_mw: float                     # inf = unbounded
    n_nodes: int
    n_jobs: int
    n_events: int
    makespan_s: float
    throughput_jobs_per_h: float
    mean_wait_s: float
    node_util_pct: float                 # used node-hours / pool capacity
    baseline_mwh: float                  # nominal (uncapped) energy
    savings_mwh: float
    savings_pct: float
    dt_pct: float                        # fleet runtime stretch vs nominal
    peak_alloc_w: float                  # max summed allocation, any event
    budget_exceeded: bool
    n_scaled_events: int                 # broker overshoots clamped by sim
    bin_caps: Tuple[float, ...]          # menu (inf first)
    bin_energy_mwh: np.ndarray           # (C,) nominal energy per menu bin
    bin_savings_mwh: np.ndarray          # (C,) scored savings per bin
    offline: bool = False
    schedule: Optional[FleetJobsReport] = None
    timeline: Optional[Dict[str, np.ndarray]] = None
    n_ticks: int = 0

    @property
    def energy_mwh(self) -> float:
        """Projected energy actually drawn (baseline minus savings)."""
        return self.baseline_mwh - self.savings_mwh

    def __str__(self) -> str:
        bud = "unbounded" if not np.isfinite(self.budget_mw) \
            else f"{self.budget_mw:.2f} MW"
        return (
            f"broker[{self.broker} @ {bud}, {self.n_nodes} nodes]: "
            f"{self.n_jobs} jobs in {self.makespan_s / 3600.0:.1f} h "
            f"({self.throughput_jobs_per_h:.1f} jobs/h, "
            f"wait {self.mean_wait_s / 60.0:.1f} min, "
            f"util {self.node_util_pct:.1f}%)\n"
            f"  energy {self.baseline_mwh:.2f} -> {self.energy_mwh:.2f} "
            f"MWh ({self.savings_pct:.2f}% saved, dT "
            f"{self.dt_pct:+.2f}%); peak alloc "
            f"{self.peak_alloc_w / 1e6:.3f} MW"
            f"{' [offline bound]' if self.offline else ''}")


def simulate_cluster(trace: ClusterTrace, broker: BrokerLike = "uniform",
                     budget_mw: Optional[float] = None, *,
                     n_nodes: int = 10_000, kind: str = "power",
                     caps: Optional[Sequence[float]] = None,
                     tables=None, backfill_depth: int = 16,
                     dt0_tol_pct: float = DT0_TOL_PCT,
                     record_timeline: bool = False,
                     **broker_knobs) -> BrokerReport:
    """Run ``trace`` through the event-driven cluster under ``broker``.

    Events: job arrivals (FCFS queue; EASY backfill up to
    ``backfill_depth`` waiting jobs, reserved against the head job's
    earliest start), job ends (exact, from the current runtime factors),
    and telemetry-chunk ticks every ``trace.chunk_s`` of simulated time.
    At each tick the whole running set is re-evaluated in one batched
    :class:`TransferSurface` pass across the cap menu on the trace's
    device and the broker reallocates; arrivals/ends between ticks adjust
    incrementally inside the remaining headroom on the host, so the
    facility invariant — summed allocated watts <= budget — holds at
    *every* event (``offline`` brokers are exempt).

    ``budget_mw=None`` means an unbounded facility (the invariant is
    trivially satisfied; brokers still shape caps by their objective).
    """
    br = get_broker(broker, **broker_knobs)
    from repro_torch.power.scenarios import resolve_tables
    dev = trace.device
    tables = resolve_tables(tables, kind=kind, chip=trace.chip, device=dev)
    if tables is None:                   # measured MI250X columns
        tables = builtin_tables(kind)
    if caps is None:
        caps = default_caps(kind, tables)
    caps = tuple(sorted((float(c) for c in caps), reverse=True))
    menu = np.array([np.inf] + list(caps), dtype=np.float64)
    n_menu = menu.size
    budget_w = np.inf if budget_mw is None else float(budget_mw) * 1e6
    if budget_w <= 0.0:
        raise ValueError(f"budget_mw must be positive, got {budget_mw}")
    nodes = _host(trace.nodes)
    if int(nodes.max()) > n_nodes:
        raise ValueError(
            f"job needs {int(nodes.max())} nodes but the pool has "
            f"{n_nodes}; no schedule exists")

    chip_model = ChipModel(trace.chip)
    surf = chip_model.surface(dev)
    j_n = trace.n_jobs
    chunk_s = trace.chunk_s

    # ---- menu-wide response factors (the offline estimator's columns)
    resp_vai = np.vstack([[100.0, 100.0, 100.0], _host(
        interp_response_batch(tables.vai, menu[1:], device="cpu"))])
    resp_mb = np.vstack([[100.0, 100.0, 100.0], _host(
        interp_response_batch(tables.mb, menu[1:], device="cpu"))])
    sav_ci = 1.0 - resp_vai[:, 2] / 100.0          # (C,)
    sav_mi = 1.0 - resp_mb[:, 2] / 100.0
    # draw factor per (mode, menu): caps bend C.I./boost power through the
    # VAI column, M.I. through MB, latency-bound not at all (paper IV-C)
    fac = np.ones((_N_MODES + 1, n_menu))
    fac[2] = resp_mb[:, 0] / 100.0
    fac[3] = fac[4] = resp_vai[:, 0] / 100.0
    draw_all = trace.chunk_power_w[:, :, None] \
        * torch.from_numpy(fac).to(dev)[trace.chunk_mode.long()]
    rt_all = 1.0 + (DT_WEIGHT_PER_CI_HOUR
                    * trace.chunk_ci_frac)[:, :, None] \
        * (torch.from_numpy(resp_vai[None, None, :, 1]).to(dev) - 100.0) \
        / 100.0
    # host mirrors of what the per-job scalar bookkeeping reads
    draw_h, rt_h = _host(draw_all), _host(rt_all)
    arrival, walltime = _host(trace.arrival_s), _host(trace.walltime_s)
    n_chunks_h = _host(trace.n_chunks)
    chunk_dur_h = _host(trace.chunk_dur_s)
    cum_ci_h, cum_mi_h = _host(trace.cum_e_ci), _host(trace.cum_e_mi)
    cum_tot_h = _host(trace.cum_e_tot)

    # menu frequencies for the model pass (column 0 = uncapped)
    if kind == "freq":
        f_menu_static = np.clip(menu / trace.chip.f_nominal_mhz,
                                chip_model.f_min_frac, 1.0)
        f_menu_static[0] = 1.0
        f_static_t = torch.from_numpy(f_menu_static).to(dev)
    else:
        f_static_t = None
    menu_t = torch.from_numpy(menu).to(dev)

    # ---- per-job state (host)
    progress = np.zeros(j_n)             # nominal seconds consumed
    acct = np.zeros(j_n)                 # nominal seconds scored
    t_last = np.zeros(j_n)
    rt_cur = np.ones(j_n)
    alloc_w = np.zeros(j_n)
    choice = np.zeros(j_n, dtype=np.int64)
    est_end = np.full(j_n, np.inf)
    start_s = np.full(j_n, np.nan)
    end_s = np.full(j_n, np.nan)

    slot_job = np.empty(j_n, dtype=np.int64)   # running set, swap-remove
    n_run = 0
    slot_of = np.full(j_n, -1, dtype=np.int64)
    free_nodes = n_nodes
    total_alloc = 0.0

    # scoreboard: nominal modal energy consumed per menu bin, accumulated
    # on the host in event order (a fixed order: reruns are bit-equal)
    bin_e_ci = np.zeros(n_menu)
    bin_e_mi = np.zeros(n_menu)
    bin_e_tot = np.zeros(n_menu)

    peak_alloc = 0.0
    n_scaled = 0
    n_events = 0
    n_ticks = 0
    tl_t: List[float] = []
    tl_run: List[int] = []
    tl_queue: List[int] = []
    tl_alloc: List[float] = []

    def interp_cum(cum: np.ndarray, idx: np.ndarray,
                   x: np.ndarray) -> np.ndarray:
        ck = np.clip((x // chunk_s).astype(np.int64), 0,
                     n_chunks_h[idx] - 1)
        base = ck * chunk_s
        dur = chunk_dur_h[idx, ck]
        frac = np.clip((x - base) / np.maximum(dur, 1e-12), 0.0, 1.0)
        lo = cum[idx, ck]
        return lo + frac * (cum[idx, ck + 1] - lo)

    # the five cumulative curves side by side, so the view interpolates
    # all of them with one gather (C.I., M.I., mode 1, total, C.I. seconds)
    cum_all = torch.stack([trace.cum_e_ci, trace.cum_e_mi, trace.cum_e_m1,
                           trace.cum_e_tot, trace.cum_ci_s], dim=-1)

    def interp_cum_t(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """:func:`interp_cum` of every curve on the device (the same
        elementwise ops): ``(R, 5)``."""
        ck = torch.clamp((x // chunk_s).to(torch.int64), min=0)
        ck = torch.minimum(ck, trace.n_chunks[idx] - 1)
        base = ck.to(_F64) * chunk_s
        dur = trace.chunk_dur_s[idx, ck]
        frac = torch.clamp((x - base) / torch.clamp(dur, min=1e-12),
                           0.0, 1.0)[:, None]
        lo = cum_all[idx, ck]
        return lo + frac * (cum_all[idx, ck + 1] - lo)

    def score(idx: np.ndarray, a: np.ndarray, b: np.ndarray,
              ch: np.ndarray) -> None:
        """Bin the nominal modal energy consumed over [a, b) under the
        menu entries ``ch`` (the offline estimator's bookkeeping)."""
        if idx.size == 0:
            return
        d_ci = interp_cum(cum_ci_h, idx, b) - interp_cum(cum_ci_h, idx, a)
        d_mi = interp_cum(cum_mi_h, idx, b) - interp_cum(cum_mi_h, idx, a)
        d_tot = interp_cum(cum_tot_h, idx, b) \
            - interp_cum(cum_tot_h, idx, a)
        np.add.at(bin_e_ci, ch, d_ci)
        np.add.at(bin_e_mi, ch, d_mi)
        np.add.at(bin_e_tot, ch, d_tot)

    if hasattr(br, "prepare"):
        br.prepare(trace, menu, kind, tables)
    offline = bool(getattr(br, "offline", False))

    # ---- event heap: (time, priority, seq, kind, payload)
    END, ARRIVE, TICK = 0, 1, 2
    heap: List[Tuple[float, int, int, int, int]] = []
    seq = 0
    order = np.argsort(arrival, kind="stable")
    for j in order:
        heap.append((float(arrival[j]), ARRIVE, seq, ARRIVE, int(j)))
        seq += 1
    heapq.heapify(heap)
    queue: List[int] = []
    end_epoch = 0
    tick_pending = False
    n_done = 0

    def push_end(now: float) -> None:
        nonlocal end_epoch, seq
        if n_run == 0:
            return
        t_end = float(est_end[slot_job[:n_run]].min())
        end_epoch += 1
        heapq.heappush(heap, (t_end, END, seq, END, end_epoch))
        seq += 1

    def push_tick(t: float) -> None:
        nonlocal tick_pending, seq
        if not tick_pending:
            heapq.heappush(heap, (t, TICK, seq, TICK, 0))
            seq += 1
            tick_pending = True

    def admit(j: int, now: float) -> None:
        nonlocal n_run, free_nodes, total_alloc
        headroom = np.inf if offline else budget_w - total_alloc
        d0 = draw_h[j, 0]
        c = int(_first_fit(d0[None, :], np.array([headroom]))[0])
        a = float(min(d0[c], headroom)) if np.isfinite(headroom) \
            else float(d0[c])
        slot_job[n_run] = j
        slot_of[j] = n_run
        n_run += 1
        free_nodes -= int(nodes[j])
        start_s[j] = now
        progress[j] = acct[j] = 0.0
        t_last[j] = now
        choice[j] = c
        rt_cur[j] = rt_h[j, 0, c]
        alloc_w[j] = max(a, 0.0)
        total_alloc += alloc_w[j]
        est_end[j] = now + walltime[j] * rt_cur[j]

    def try_admit(now: float) -> bool:
        """FCFS head-of-queue admission + EASY backfill. Returns True if
        anything started."""
        started = False
        while queue:
            head = queue[0]
            headroom = np.inf if offline else budget_w - total_alloc
            need_w = 0.0 if offline else float(draw_h[head, 0, -1])
            fits_w = headroom >= need_w * (1.0 - _EPS) or n_run == 0
            if nodes[head] <= free_nodes and fits_w:
                admit(queue.pop(0), now)
                started = True
                continue
            # head blocked: reserve its earliest start, backfill behind it
            if n_run == 0:
                break
            run = slot_job[:n_run]
            ends = np.sort(est_end[run])
            freed = np.cumsum(nodes[run][np.argsort(est_end[run],
                                                    kind="stable")])
            need = nodes[head] - free_nodes
            pos = int(np.searchsorted(freed, need))
            t_res = float(ends[min(pos, ends.size - 1)])
            for qi in range(1, min(len(queue), backfill_depth + 1)):
                q = queue[qi]
                headroom = np.inf if offline else budget_w - total_alloc
                need_w = 0.0 if offline else float(draw_h[q, 0, -1])
                if nodes[q] <= free_nodes \
                        and headroom >= need_w * (1.0 - _EPS) \
                        and now + walltime[q] <= t_res * (1.0 + _EPS):
                    admit(queue.pop(qi), now)
                    started = True
                    break
            else:
                break
        return started

    def finish(j: int, now: float) -> None:
        nonlocal n_run, free_nodes, total_alloc, n_done
        score(np.array([j]), np.array([acct[j]]),
              np.array([walltime[j]]), np.array([choice[j]]))
        acct[j] = progress[j] = walltime[j]
        end_s[j] = now
        s = slot_of[j]
        last = slot_job[n_run - 1]
        slot_job[s] = last
        slot_of[last] = s
        slot_of[j] = -1
        n_run -= 1
        free_nodes += int(nodes[j])
        total_alloc -= alloc_w[j]
        alloc_w[j] = 0.0
        est_end[j] = np.inf
        n_done += 1

    def build_view(now: float, idx: np.ndarray,
                   cidx: np.ndarray) -> BrokerView:
        it = torch.from_numpy(idx).to(dev)
        ct = torch.from_numpy(cidx).to(dev)
        prog = torch.from_numpy(progress[idx]).to(dev)
        power = trace.chunk_unit_power_w[it, ct]
        mode = torch.clamp(trace.chunk_mode[it, ct], min=1)
        profiles = surf.infer_profiles(
            power, freq_frac=1.0, duration_s=chunk_s, mode_idx=mode)
        if f_static_t is not None:
            f_cr = f_static_t[:, None].expand(n_menu, idx.size)
        else:
            f_cr = torch.empty((n_menu, idx.size), dtype=_F64, device=dev)
            f_cr[0] = 1.0
            f_cr[1:] = surf.freq_for_power_cap(profiles, menu_t[1:, None])
        # the model columns decisions_at would give: energy is power x time
        model_t = surf.step_time(profiles, f_cr)
        model_p = surf.power_w(profiles, f_cr)
        obs = interp_cum_t(it, prog)
        obs_ci_e, obs_mi_e, obs_m1_e, obs_tot = (obs[:, i] for i in range(4))
        obs_e = torch.stack(
            [obs_m1_e, obs_mi_e, obs_ci_e,
             torch.clamp(obs_tot - obs_m1_e - obs_mi_e - obs_ci_e,
                         min=0.0)], dim=1)
        # model columns are per GCD; scale energy/power to job level so
        # greedy's penalty-per-watt-shed compares like with like against
        # the node-scaled draw_w
        nd = trace.nodes[it]
        w = nd.to(_F64)[:, None]
        return BrokerView(
            now_s=now, budget_w=budget_w, n_nodes=n_nodes,
            free_nodes=free_nodes, kind=kind, menu_caps=menu,
            tables=tables, chip=chip_model,
            sample_interval_s=trace.sample_interval_s,
            job_idx=it, nodes=nd,
            draw_w=draw_all[it, ct], rt=rt_all[it, ct],
            profiles=profiles,
            model_energy_j=(model_p * model_t).T * w,
            model_time_s=model_t.T,
            model_power_w=model_p.T * w,
            obs_energy_mwh=obs_e,
            obs_time_s=prog,
            obs_ci_s=obs[:, 4])

    def tick(now: float) -> None:
        nonlocal total_alloc, n_scaled, n_ticks
        idx = slot_job[:n_run].copy()
        if idx.size:
            n_ticks += 1
            # advance nominal progress at the rates in force since each
            # job's last accounting point, then score the elapsed span
            progress[idx] = np.minimum(
                progress[idx] + (now - t_last[idx]) / rt_cur[idx],
                walltime[idx])
            t_last[idx] = now
            score(idx, acct[idx], progress[idx], choice[idx])
            acct[idx] = progress[idx]
            cidx = np.clip((progress[idx] // chunk_s).astype(np.int64),
                           0, n_chunks_h[idx] - 1)
            view = build_view(now, idx, cidx)
            ch = np.asarray(_host(br.allocate(view)), dtype=np.int64)
            if ch.shape != (idx.size,):
                raise ValueError(
                    f"broker {br.name!r} returned choices of shape "
                    f"{ch.shape}, expected ({idx.size},)")
            ch = np.clip(ch, 0, n_menu - 1)
            a = draw_h[idx, cidx, ch]
            tot = float(a.sum())
            if not offline and tot > budget_w * (1.0 + _EPS):
                a = a * (budget_w / tot)        # structural invariant
                n_scaled += 1
            choice[idx] = ch
            rt_cur[idx] = rt_h[idx, cidx, ch]
            alloc_w[idx] = a
            total_alloc = float(a.sum())
            est_end[idx] = now + (walltime[idx] - progress[idx]) \
                * rt_cur[idx]

    # ---- main loop
    t0 = float(arrival[order[0]]) if j_n else 0.0
    while heap:
        t, _prio, _seq, ev, payload = heapq.heappop(heap)
        n_events += 1
        if ev == ARRIVE:
            queue.append(payload)
            if try_admit(t):
                push_end(t)
            push_tick(t + chunk_s)
        elif ev == END:
            if payload != end_epoch:
                n_events -= 1
                continue            # stale epoch: reallocation moved ends
            run = slot_job[:n_run]
            ended = run[est_end[run] <= t * (1.0 + _EPS) + 1e-6]
            for j in ended:
                finish(int(j), t)
            try_admit(t)
            push_end(t)
        else:                       # TICK
            tick_pending = False
            tick(t)
            try_admit(t)
            push_end(t)
            if n_run > 0 or queue:
                push_tick(t + chunk_s)
        if not offline:
            peak_alloc = max(peak_alloc, total_alloc)
        if record_timeline:
            tl_t.append(t)
            tl_run.append(n_run)
            tl_queue.append(len(queue))
            tl_alloc.append(total_alloc)

    if n_done != j_n:
        raise RuntimeError(
            f"simulation ended with {j_n - n_done} unfinished jobs — "
            f"event starvation bug")

    # ---- report
    baseline = float(bin_e_tot.sum())
    bin_sav = bin_e_ci * sav_ci + bin_e_mi * sav_mi
    schedule = getattr(br, "schedule", None)
    if offline and schedule is not None:
        savings = float(schedule.total_savings_mwh)
        savings_pct = float(schedule.savings_pct)
    else:
        savings = float(bin_sav.sum())
        savings_pct = 100.0 * savings / max(baseline, 1e-12)
    makespan = float(np.nanmax(end_s) - t0) if j_n else 0.0
    runtime = end_s - start_s
    timeline = None
    if record_timeline:
        timeline = dict(t_s=np.array(tl_t), running=np.array(tl_run),
                        queued=np.array(tl_queue),
                        alloc_w=np.array(tl_alloc))
    return BrokerReport(
        broker=br.name, kind=kind, chip=trace.chip.name,
        budget_mw=budget_w / 1e6, n_nodes=n_nodes, n_jobs=j_n,
        n_events=n_events, makespan_s=makespan,
        throughput_jobs_per_h=3600.0 * j_n / max(makespan, 1e-9),
        mean_wait_s=float(np.mean(start_s - arrival)),
        node_util_pct=100.0 * float((nodes * runtime).sum())
        / max(n_nodes * makespan, 1e-9),
        baseline_mwh=baseline, savings_mwh=savings,
        savings_pct=savings_pct,
        dt_pct=100.0 * (float(runtime.sum())
                        / max(float(walltime.sum()), 1e-12) - 1.0),
        peak_alloc_w=peak_alloc,
        budget_exceeded=bool(peak_alloc > budget_w * (1.0 + 1e-6)),
        n_scaled_events=n_scaled,
        bin_caps=tuple(float(c) for c in menu),
        bin_energy_mwh=bin_e_tot, bin_savings_mwh=bin_sav,
        offline=offline, schedule=schedule, timeline=timeline,
        n_ticks=n_ticks)
