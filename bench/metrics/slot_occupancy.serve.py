"""Mean share of the pool's slots decoded a tick, over the window's ticks
outside the traced part (the scheduler's admissions keep it full)."""
from bench.core import stats


def read(r):
    if r["kind"] != "serve" or not r["ticks"]:
        return None
    ticks = r["ticks"]
    return stats.share(sum(t.n_dec for t in ticks), len(ticks) * r["clients"])
