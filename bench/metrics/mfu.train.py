"""Model flops of the window's steps outside the traced part (6 x the
parameters of the products x tokens, plus 3 x the causal attention's
forward) over their seconds, as a share of the bf16 peak."""
from bench.core import stats, work


def read(r):
    if r["kind"] != "train" or not r["steps"]:
        return None
    t = r["traffic"]
    flops = r["steps"] * work.train_step_flops(r["model"], t["batch"],
                                               t["seq_len"])
    return stats.share(flops / r["seconds"], work.PEAKS["bf16_flops"])
