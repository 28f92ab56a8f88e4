"""The driver of the traffic kind ``serve_closed_loop``: the port's
``serve()`` over its ``ContinuousEngine``, driven as it is, closed loop,
through a recorder that stands between them.

The recorder hands every engine call on unchanged. It times each tick at
``observe``, which ``serve()`` calls once a tick after its own host sync
(the tick's tokens are on the host then), and adds no sync of its own. The
pool is filled and ``ramp_ticks`` ticks run before the window opens (set-up);
the window opens at the end of a tick and closes at the end of the first
tick that ends ``seconds`` or more later: the recorder then raises, which
ends ``serve()``. Tokens count when their tick ends inside the window. A
request is due at the end of the tick that freed its client's slot, and
admitted at the start of the next; its first token is ready at the end of
that tick (the first sync after its prefill), its later tokens at the end
of each tick that decodes it.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd.profiler import record_function

from bench.core import stats, traffic


class WindowClosed(Exception):
    """Raised by the recorder at the end of the window's last tick."""


@dataclasses.dataclass
class Tick:
    t_end: float
    dur: float
    n_dec: int                # slots decoded this tick (a token each)
    admitted: List[int]       # requests admitted (prefilled) this tick
    keys: int                 # sum over decoded slots of positions attended
    traced: bool = False


class Recorder:
    """Stands in for the engine in ``serve()``."""

    def __init__(self, engine, requests, ramp_ticks: int, seconds: float,
                 trace_ticks: int = 0, profiler=None):
        self.engine = engine
        self.index = {id(r): i for i, r in enumerate(requests)}
        self.lens = [len(r.prompt) for r in requests]
        self.ramp_ticks, self.seconds = ramp_ticks, seconds
        self.trace_ticks, self.profiler = trace_ticks, profiler
        self.ticks: List[Tick] = []
        self.tokens: List[Optional[torch.Tensor]] = []  # a tick's tokens
        self.first: Dict[int, torch.Tensor] = {}  # request -> first token
        self.slot_of: Dict[int, int] = {}        # request -> slot
        self.admit_tick: Dict[int, int] = {}     # request -> tick
        self.max_new: Dict[int, int] = {}
        self.slot_req = [-1] * engine.max_slots
        self.slot_steps = [0] * engine.max_slots
        self.t_start = time.perf_counter()
        self.t_last = self.t_start
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.first_window_tick: Optional[int] = None
        self._adm: List[int] = []
        self._dec = (0, 0)
        self._toks: Optional[torch.Tensor] = None
        self._window_range = None

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def prefill(self, request, temperature: float = 0.0):
        i = self.index[id(request)]
        with record_function("bench.prefill"):
            pf = self.engine.prefill(request, temperature)
        self.first[i] = pf.token
        self.max_new[i] = pf.max_new
        self._adm.append(i)
        return pf

    def insert(self, prefix, slot: int) -> None:
        with record_function("bench.insert"):
            self.engine.insert(prefix, slot)
        i = self._adm[-1]
        self.slot_of[i] = slot
        self.admit_tick[i] = len(self.ticks)
        self.slot_req[slot] = i
        self.slot_steps[slot] = 0

    def generate_step(self, active=None):
        act = np.array(active, dtype=bool)
        with record_function("bench.decode"):
            toks = self.engine.generate_step(active)
        keys = 0
        for s in np.flatnonzero(act):
            i = self.slot_req[s]
            keys += self.lens[i] + self.slot_steps[s] + 1
            self.slot_steps[s] += 1
        self._toks = toks
        self._dec = (int(act.sum()), keys)
        return toks

    def observe(self, n_prefills: int, n_decode: int = 1, wall_s=None):
        t = time.perf_counter()
        n = len(self.ticks)
        in_window = self.t0 is not None
        traced = in_window and self._window_range is not None
        self.ticks.append(Tick(t, t - self.t_last, self._dec[0],
                               self._adm, self._dec[1], traced))
        self.t_last = t
        self.tokens.append(self._toks)
        self._adm, self._dec, self._toks = [], (0, 0), None
        out = self.engine.observe(n_prefills, n_decode, wall_s)
        if not in_window and n + 1 == self.ramp_ticks:
            self._open(t, n + 1)
        elif in_window:
            if traced and n + 1 - self.first_window_tick >= self.trace_ticks:
                self._stop_trace()
            if t >= self.t0 + self.seconds:
                self.t1 = t
                if self._window_range is not None:
                    self._stop_trace()
                raise WindowClosed()
        return out

    def _open(self, t: float, first_tick: int) -> None:
        self.first_window_tick = first_tick
        gc.collect()
        gc.freeze()
        if self.profiler is not None and self.trace_ticks:
            self.profiler.start()
            self._window_range = record_function("bench.window")
            self._window_range.__enter__()
        self.t0 = self.t_last = time.perf_counter()

    def _stop_trace(self) -> None:
        self._window_range.__exit__(None, None, None)
        self._window_range = None
        self.profiler.stop()
        # the profiler's own work after its stop belongs to no tick
        self.t_last = time.perf_counter()

    # ------------------------------------------------------------ records
    def window_ticks(self) -> List[Tick]:
        return self.ticks[self.first_window_tick:]

    def finished(self) -> List[int]:
        """Requests whose last token came at a tick inside the window."""
        out = []
        last = len(self.ticks) - 1
        for i, a in self.admit_tick.items():
            end = a + self.max_new[i] - 2
            if self.first_window_tick <= end <= last:
                out.append(i)
        return out

    def served(self, ids: List[int]) -> Dict[int, np.ndarray]:
        """The tokens each request in ``ids`` was served, on the host."""
        blank = torch.full_like(next(x for x in self.tokens
                                     if x is not None), -1)
        toks = torch.stack([blank if x is None else x
                            for x in self.tokens]).cpu().numpy()
        firsts = torch.stack([self.first[i] for i in ids]).cpu().numpy()
        out = {}
        for i, f in zip(ids, firsts):
            a, s = self.admit_tick[i], self.slot_of[i]
            rest = toks[a:a + self.max_new[i] - 1, s]
            out[i] = np.concatenate([[f], rest]).astype(np.int64)
        return out


def end_to_end(rec: Recorder) -> Dict[str, float]:
    """The cell's end-to-end numbers from the window's ticks."""
    ticks = rec.window_ticks()
    secs = rec.t1 - rec.t0
    tokens = sum(t.n_dec + len(t.admitted) for t in ticks)
    ttft = [t.dur for t in ticks for _ in t.admitted]
    tpot = [t.dur for t in ticks for _ in range(t.n_dec - len(t.admitted))]
    dec = [t.dur for t in ticks if not t.admitted]
    adm = [t.dur for t in ticks if t.admitted]
    return {"serve_out_tok_s": stats.rate(tokens, secs),
            "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95),
            "tpot_p95_ms": 1e3 * stats.percentile(tpot, 95),
            "requests": len(ttft), "tokens": tokens, "window_s": secs,
            "ticks": len(ticks),
            "decode_tick_ms": 1e3 * sum(dec) / max(len(dec), 1),
            "admit_tick_ms": 1e3 * sum(adm) / max(len(adm), 1)}


def prefill_page(t: Dict, length: int) -> int:
    """The page a prompt of ``length`` tokens is prefilled at: the least
    power-of-two multiple of the mix's ``page`` that holds it, at most
    ``max_len`` (the rows past the prompt are padding)."""
    b = t["page"]
    while b < length:
        b *= 2
    return min(b, t["max_len"])


def build(model: Dict, t: Dict, w, program):
    """The engine on the benchmark's weights ``w``, and the request list."""
    cfg, rt = program.config(model), program.runtime(model)
    params = w.tree()
    program.check_layout(cfg, rt, params)
    engine = program.serving.ContinuousEngine(
        cfg, rt, params, max_slots=t["clients"], max_len=t["max_len"],
        page=t["page"])
    reqs = [program.serving.Request(p, max_new_tokens=o)
            for p, o in traffic.serve_requests(t, model["vocab_size"], w.seed)]
    return engine, reqs


def warm(engine, reqs, device) -> None:
    """One prefill at each page the traffic reaches (inserted into slot 0)
    and one decode step of the whole pool."""
    pages = sorted({engine._bucket(len(r.prompt)) for r in reqs})
    for page in pages:
        r = next(r for r in reqs if engine._bucket(len(r.prompt)) == page)
        engine.insert(engine.prefill(r), 0)
    engine.generate_step(np.ones(engine.max_slots, bool))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(engine, reqs, t: Dict, seconds: float, trace: bool,
               program) -> Recorder:
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
    rec = Recorder(engine, reqs, t["ramp_ticks"], seconds,
                   t.get("trace_ticks", 0) if trace else 0, prof)
    try:
        program.serving.serve(rec, reqs)
    except WindowClosed:
        pass
    else:
        raise RuntimeError(f"the {len(reqs)} requests ran out before the "
                           f"window closed")
    finally:
        gc.unfreeze()
    rec.prof = prof
    return rec


def sample(rec: Recorder, check: Dict, seed: int) -> List[int]:
    """The requests the check compares: the longest finished, then others
    drawn from the seed, until ``min_tokens`` served tokens or
    ``max_requests`` requests."""
    done = rec.finished()
    if not done:
        raise RuntimeError("no request finished inside the window")
    longest = max(done, key=lambda i: (rec.max_new[i], -i))
    rest = [i for i in done if i != longest]
    order = traffic.rng(seed, 3).permutation(len(rest))
    ids, n = [longest], rec.max_new[longest]
    for j in order:
        if n >= check["min_tokens"] or len(ids) >= check["max_requests"]:
            break
        ids.append(rest[j])
        n += rec.max_new[rest[j]]
    return ids


def _gaps(lg: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each token's logit lies."""
    return lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]


def check(model: Dict, t: Dict, rec: Recorder, reqs, ids: List[int], w,
          reference, control: bool) -> Dict:
    """The gaps by which the served tokens' logits lie below the
    reference's best, over every token served to the sampled requests:
    the widest (``served_gap_max``), the mean (``served_gap_mean``) and the
    share of tokens not the reference's first (``served_miss``). With
    ``control`` the same of the token the fp8 reference puts first at each
    of those positions (``control_*``). Each prompt's rows are routed as
    one prefill of its page (:func:`prefill_page`), its served tokens' rows
    one at a time."""
    served = rec.served(ids)
    device = w.device
    seqs, want, groups = [], [], []
    for i in ids:
        p = np.asarray(reqs[i].prompt, np.int64)
        s = served[i]
        seqs.append(torch.from_numpy(np.concatenate([p, s[:-1]])).to(device))
        want.append(torch.arange(len(p) - 1, len(p) + len(s) - 1,
                                 device=device))
        groups.append((len(p), prefill_page(t, len(p))))
    precisions = ("f32", "fp8") if control else ("f32",)
    old = reference.set_exact_matmul()
    try:
        with torch.no_grad():
            logits = reference.serve_logits(model, w.prefix, seqs, want,
                                            groups, precisions)
    finally:
        reference.restore_matmul(old)
    sides = {"served": [], "control": []}
    for k, i in enumerate(ids):
        lg = logits["f32"][k]
        sides["served"].append(_gaps(lg, torch.from_numpy(served[i]).to(
            device)))
        if control:
            sides["control"].append(_gaps(lg, logits["fp8"][k].argmax(-1)))
    out: Dict = {"tokens": sum(len(g) for g in sides["served"])}
    for side, gaps in sides.items():
        if gaps:
            g = torch.cat(gaps)
            out[f"{side}_gap_max"] = float(g.max())
            out[f"{side}_gap_mean"] = float(g.mean())
            out[f"{side}_miss"] = float((g > 0).float().mean())
    return out


def per_layer_records(model: Dict, t: Dict, rec: Recorder) -> Dict:
    """What the per-layer readers take: the window's ticks outside the
    traced part, the traced part's prompts and its trace."""
    from bench.core import trace as trace_mod
    ticks = rec.window_ticks()
    untraced = [x for x in ticks if not x.traced] or ticks
    traced = [x for x in ticks if x.traced]
    out = {"kind": "serve", "model": model, "traffic": t,
           "clients": t["clients"], "ticks": untraced,
           "lens": rec.lens, "traced_prompts": [rec.lens[i] for x in traced
                                                for i in x.admitted]}
    if rec.prof is not None:
        out["trace"] = trace_mod.reduce(rec.prof)
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool) -> Dict:
    """One run of a serving cell: set-up, window, check (see
    :func:`bench.core.harness.run_cell`)."""
    from bench.core import program
    t = cell.traffic
    w = cell.weights(seed, device)
    engine, reqs = build(cell.model, t, w, program)
    warm(engine, reqs, device)
    rec = run_window(engine, reqs, t, seconds, trace, program)
    e2e = end_to_end(rec)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    records = per_layer_records(cell.model, t, rec)
    ids = sample(rec, cell.cell["check"], seed)
    del engine
    rec.engine = None
    program.free_memory()
    numbers = check(cell.model, t, rec, reqs, ids, w, cell.reference(),
                    control)
    numbers.update({k: e2e[k] for k in ("requests", "ticks",
                                        "decode_tick_ms", "admit_tick_ms")})
    return {"t0": rec.t0, "e2e": e2e, "records": records,
            "numbers": numbers, "attempted": e2e["requests"], "peak": peak}
