"""Continuous-batching scheduler: an open-loop request queue over a
:class:`~repro_torch.serving.ContinuousEngine` slot pool.

Every tick admits arrived requests into free slots (prefill + insert), runs
one ``generate_step`` across the pool, and evicts finished sequences —
freed slots are refilled on the very next tick, so the pool stays full
under load with no lock-step barrier. Time is counted in *decode steps*,
not wall-clock: arrival processes expressed in step units make scheduling
decisions (and tests) machine-independent.

A copy of the reference's scheduler; the engine's sampled tokens come back
as a tensor on the card and are read on the host once per tick.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch


def _to_host(tokens) -> np.ndarray:
    if isinstance(tokens, torch.Tensor):
        return tokens.cpu().numpy()
    return np.asarray(tokens)


def poisson_arrivals(n: int, rate_per_step: float, seed: int = 0
                     ) -> np.ndarray:
    """Open-loop Poisson arrival times in decode-step units: cumulative sum
    of exponential inter-arrival gaps at ``rate_per_step`` requests/step."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_per_step, size=n))


@dataclass
class ServeReport:
    """What a :func:`serve` run did: per-request outputs plus the throughput
    and occupancy accounting the bench contract is scored on."""
    outputs: List[np.ndarray]          # per request, [max_new] int32
    n_steps: int                       # decode steps executed
    n_prefills: int
    wall_s: float
    tokens_out: int                    # generated tokens actually requested
    occupancy_mean: float              # mean occupied slots per decode step
    queue_peak: int                    # max requests waiting for a slot
    session: Optional[object] = None   # the engine's EnergySession, if any

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(self.wall_s, 1e-9)


def serve(engine, requests: Sequence, arrivals: Optional[Sequence] = None,
          temperature: float = 0.0) -> ServeReport:
    """Serve ``requests`` through the engine's slot pool to completion.

    ``arrivals`` gives each request's arrival time in decode-step units
    (default: everything queued at t=0). Each tick: admit as many arrived
    requests as there are free slots, step the pool once, evict finished
    sequences. With an :class:`~repro_torch.power.EnergySession` on the engine,
    each tick reports its prefills and decode step as distinct roofline
    profiles — the per-phase power-policy hook.
    """
    n = len(requests)
    arr = (np.zeros(n) if arrivals is None
           else np.asarray(arrivals, dtype=float))
    if len(arr) != n:
        raise ValueError(f"{len(arr)} arrival times for {n} requests")
    order = np.argsort(arr, kind="stable")
    arr_sorted = arr[order]

    S = engine.max_slots
    outputs: List[Optional[np.ndarray]] = [None] * n
    partial: List[Optional[List[int]]] = [None] * n
    slot_req = [-1] * S                 # request index occupying each slot
    slot_left = np.zeros(S, np.int64)   # tokens still to generate per slot
    active = np.zeros(S, bool)
    free = list(range(S))[::-1]
    qi = 0                              # next arrival (in sorted order)
    done = 0
    step = 0
    occ_sum = 0
    decode_ticks = 0
    queue_peak = 0
    t0 = time.perf_counter()
    while done < n:
        tick_t0 = time.perf_counter()
        n_pre = 0
        while free and qi < n and arr_sorted[qi] <= step:
            i = int(order[qi])
            qi += 1
            slot = free.pop()
            pf = engine.prefill(requests[i], temperature)
            engine.insert(pf, slot)
            # keep the first token as a device scalar: forcing it here would
            # serialize every admission on its own B=1 prefill; it is
            # materialized at eviction, when the value is long since ready
            partial[i] = [pf.token]
            n_pre += 1
            if pf.max_new <= 1:         # done at prefill: slot never decodes
                outputs[i] = np.asarray([int(v) for v in partial[i]],
                                        np.int32)
                done += 1
                free.append(slot)
            else:
                slot_req[slot] = i
                slot_left[slot] = pf.max_new - 1
                active[slot] = True
        arrived = int(np.searchsorted(arr_sorted, step, side="right"))
        queue_peak = max(queue_peak, arrived - qi)
        if active.any():
            toks = _to_host(engine.generate_step(active))
            occ_sum += int(active.sum())
            decode_ticks += 1
            for s in np.flatnonzero(active):
                i = slot_req[s]
                partial[i].append(int(toks[s]))
                slot_left[s] -= 1
                if slot_left[s] == 0:
                    active[s] = False
                    slot_req[s] = -1
                    free.append(int(s))
                    outputs[i] = np.asarray([int(v) for v in partial[i]],
                                            np.int32)
                    done += 1
            engine.observe(n_pre, 1,
                           wall_s=time.perf_counter() - tick_t0)
            step += 1
        else:
            if n_pre:
                engine.observe(n_pre, 0,
                               wall_s=time.perf_counter() - tick_t0)
            if done < n and qi < n:
                # pool idle until the next arrival: skip the dead time
                step = max(step + 1, int(np.ceil(arr_sorted[qi])))
    wall_s = time.perf_counter() - t0
    return ServeReport(
        outputs=outputs, n_steps=decode_ticks, n_prefills=engine.n_prefills,
        wall_s=wall_s, tokens_out=int(sum(len(o) for o in outputs)),
        occupancy_mean=occ_sum / max(decode_ticks, 1),
        queue_peak=queue_peak,
        session=getattr(engine, "session", None))
