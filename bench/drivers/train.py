"""The driver of the traffic kind ``train``: the port's ``make_train_step`` on a state of
``{"params", "opt"}`` that set-up builds once, on batches the benchmark
draws. Set-up drives that state through the check's first steps (they warm
every shape the window uses); the window takes the same state and the same
call on, a step after another, each step's loss read on the host (its
sync), and closes at the end of the first step that ends ``seconds`` or more
after it opened: the rate is every token of the window's steps over the
window's whole length."""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch
from torch.autograd.profiler import record_function

from bench.core import stats, traffic, weights


def leaf_norms(tree) -> Dict[str, float]:
    return {p: float(torch.linalg.vector_norm(t.float()))
            for p, t in weights.tree_paths(tree)}


def setup(model: Dict, t: Dict, opt: Dict, w, device, program):
    """The state after the check's steps, the step, and what the check
    reads of the program: each step's loss, the first step's gradient
    norm before clipping and each leaf's first gradient as the optimizer
    took it (from its first moment), each leaf's change after the check's
    steps."""
    cfg = program.config(model)
    step, make_state = program.train_step(cfg, opt)
    seed = w.seed
    params = w.tree()
    program.check_layout(cfg, program.runtime(model), params)
    state = make_state(params)
    del params
    got: Dict = {"losses": []}
    for k in range(1, t["check_steps"] + 1):
        batch = {"tokens": traffic.train_tokens(t, model["vocab_size"],
                                                seed, k, device)}
        state, metrics = step(state, batch)
        got["losses"].append(float(metrics["loss"]))
        if k == 1:
            got["grad1_norm"] = float(metrics["grad_norm"])
            got["grad1_leaf"] = {p: v / (1 - opt["b1"]) for p, v in
                                 leaf_norms(state["opt"]["m"]).items()}
    now = dict(weights.tree_paths(state["params"]))
    with torch.no_grad():
        got["change_leaf"] = {
            p: float(torch.linalg.vector_norm(now[p].float() - p0.float()))
            for p, p0 in w.prefix("")}
    del now
    # the window takes the state out of the box: no one else holds it
    return {"state": state}, step, got


def run_window(model: Dict, t: Dict, seed: int, box: Dict, step,
               seconds: float, trace: bool, device) -> Dict:
    """Steps after the check's, until the first that ends ``seconds`` after
    the window opened. With ``trace`` the first ``trace_steps`` of them are
    traced."""
    state = box.pop("state")
    prof = None
    n_trace = t.get("trace_steps", 0) if trace else 0
    k = t["check_steps"]
    starts: List[float] = []
    ends: List[float] = []
    traced: List[bool] = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    rng_ = None
    gc.collect()
    gc.freeze()
    if n_trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        rng_ = record_function("bench.window")
        rng_.__enter__()
    t0 = time.perf_counter()
    while True:
        k += 1
        starts.append(time.perf_counter())
        with record_function("bench.batch"):
            batch = {"tokens": traffic.train_tokens(
                t, model["vocab_size"], seed, k, device)}
        with record_function("bench.step"):
            state, metrics = step(state, batch)
        with record_function("bench.sync"):
            float(metrics["loss"])
        now = time.perf_counter()
        ends.append(now)
        traced.append(rng_ is not None)
        if rng_ is not None and len(ends) >= n_trace:
            rng_.__exit__(None, None, None)
            rng_ = None
            prof.stop()
        if now >= t0 + seconds:
            break
    if rng_ is not None:
        rng_.__exit__(None, None, None)
        prof.stop()
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    return {"state": state, "t0": t0, "starts": starts, "ends": ends,
            "traced": traced,
            "prof": prof, "window_peak_bytes": peak}


def end_to_end(model: Dict, t: Dict, win: Dict) -> Dict[str, float]:
    secs = win["ends"][-1] - win["t0"]
    tokens = len(win["ends"]) * t["batch"] * t["seq_len"]
    return {"train_tok_s": stats.rate(tokens, secs), "steps":
            len(win["ends"]), "window_s": secs}


def check(model: Dict, t: Dict, opt: Dict, w, reference,
          precision: str = "f32") -> Dict:
    """The reference's steps from the same weights on the same batches."""
    batches = [traffic.train_tokens(t, model["vocab_size"], w.seed, k,
                                    w.device)
               for k in range(1, t["check_steps"] + 1)]
    old = reference.set_exact_matmul()
    try:
        return reference.train_steps(model, opt, w.prefix, batches,
                                     precision)
    finally:
        reference.restore_matmul(old)


def compare(got: Dict, ref: Dict, min_share: float) -> Dict[str, float]:
    """The check's numbers: the worst step's loss gap, the first gradient's
    global-norm gap, and the worst leaf's gap of its first-gradient norm
    and of its change's norm, each against the reference's norm of that
    leaf or the median leaf's, whichever is larger. Leaves whose reference
    gradient is under ``min_share`` of the median leaf's are left out of
    the leaf numbers."""
    import numpy as np
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                    ref["losses"]))
    gn = abs(got["grad1_norm"] - ref["grad1_norm"]) / ref["grad1_norm"]
    g_med = float(np.median(list(ref["grad1_leaf"].values())))
    c_med = float(np.median(list(ref["change_leaf"].values())))
    keep = [p for p, v in ref["grad1_leaf"].items() if v >= min_share * g_med]

    def gaps(key, med):
        return {p: abs(got[key][p] - ref[key][p]) / max(ref[key][p], med)
                for p in keep}
    g1, ch = gaps("grad1_leaf", g_med), gaps("change_leaf", c_med)
    return {"loss": loss, "grad1_norm": gn,
            "grad1_leaf": max(g1.values()),
            "change_leaf": max(ch.values()),
            "grad1_leaf_at": max(g1, key=g1.get),
            "change_leaf_at": max(ch, key=ch.get),
            "leaves_left_out": len(ref["grad1_leaf"]) - len(keep)}


def per_layer_records(model: Dict, t: Dict, win: Dict) -> Dict:
    from bench.core import trace as trace_mod
    starts, ends, traced = win["starts"], win["ends"], win["traced"]
    idx = [i for i, tr in enumerate(traced) if not tr] or list(
        range(len(ends)))
    out = {"kind": "train", "model": model, "traffic": t,
           "steps": len(idx),
           "seconds": sum(ends[i] - starts[i] for i in idx),
           "window_peak_bytes": win["window_peak_bytes"]}
    if win["prof"] is not None:
        out["trace"] = trace_mod.reduce(win["prof"])
    return out


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: bool) -> Dict:
    """One run of a training cell: set-up, window, check (see
    :func:`bench.core.harness.run_cell`)."""
    from bench.core import program
    t, opt = cell.traffic, cell.config["optimizer"]
    w = cell.weights(seed, device)
    box, step, got = setup(cell.model, t, opt, w, device, program)
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    win = run_window(cell.model, t, seed, box, step, seconds, trace, device)
    e2e = end_to_end(cell.model, t, win)
    peak = max(setup_peak, win["window_peak_bytes"])
    records = per_layer_records(cell.model, t, win)
    win["state"] = None
    del step
    program.free_memory()
    ref = cell.reference()
    min_share = cell.cell["check"]["min_share"]
    r = check(cell.model, t, opt, w, ref)
    numbers = compare(got, r, min_share)
    numbers["setup_peak_bytes"] = setup_peak
    if control:
        ctrl = compare(check(cell.model, t, opt, w, ref, "fp8"), r,
                       min_share)
        numbers.update({f"control_{k}": v for k, v in ctrl.items()
                        if k in cell.cell["limits"]})
    return {"t0": win["t0"], "e2e": e2e, "records": records,
            "numbers": numbers, "attempted": e2e["steps"], "peak": peak}
