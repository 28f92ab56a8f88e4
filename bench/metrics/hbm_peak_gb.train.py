"""``torch.cuda.max_memory_allocated()`` over the window, in GB."""


def read(r):
    if r["kind"] != "train" or not r["window_peak_bytes"]:
        return None
    return r["window_peak_bytes"] / 1e9
