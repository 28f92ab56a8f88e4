"""Share of the traced window in which no operation runs on the device."""
from bench.core import stats


def read(r):
    tr = r.get("trace")
    if r["kind"] != "train" or tr is None or tr["window_s"] <= 0:
        return None
    return stats.share(tr["window_s"] - tr["busy_s"], tr["window_s"])
