"""The least time the prefill attention of the traced prompts needs (the
causal triangle of each true prompt at 2 (D + Dv) flops an entry, q, k, v
and o once, on the bf16 peak and HBM's bandwidth), as a share of the
device time of the flash kernels (by the names below) in the trace."""
from bench.core import stats, work

KERNELS = ("flash_fwd",)
ITEMSIZE = 2


def read(r):
    tr = r.get("trace")
    if r["kind"] != "serve" or tr is None or not r["traced_prompts"]:
        return None
    dev = sum(s for n, s in tr["device_by_name"].items()
              if any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    need = sum(work.least_seconds(*work.prefill_attention_need(
        r["model"], n, ITEMSIZE)) for n in r["traced_prompts"])
    return stats.share(need, dev)
