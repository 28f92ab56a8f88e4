"""Model flops of the window's work (2 x the active parameters of each
token's products plus its causal attention, over true lengths: every
prompt admitted and every token decoded) over the window's seconds outside
the traced part, as a share of the bf16 peak."""
from bench.core import stats, work


def read(r):
    if r["kind"] != "serve" or not r["ticks"]:
        return None
    m = r["model"]
    flops = 0.0
    for t in r["ticks"]:
        flops += t.n_dec * 2.0 * work.matmul_params(m)
        flops += m["n_layers"] * work.attn_entry_flops(m) * t.keys
        flops += sum(work.prefill_flops(m, r["lens"][i]) for i in t.admitted)
    secs = sum(t.dur for t in r["ticks"])
    return stats.share(flops / secs, work.PEAKS["bf16_flops"])
