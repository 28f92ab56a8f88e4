"""Device milliseconds launched under the benchmark's ``bench.prefill``
ranges (``ContinuousEngine.prefill``) per 1000 true prompt tokens, in the
traced part of the window."""


def read(r):
    tr = r.get("trace")
    if r["kind"] != "serve" or tr is None or not r["traced_prompts"]:
        return None
    dev = tr["range_device_s"].get("bench.prefill", 0.0)
    if dev <= 0:
        return None
    return dev * 1e6 / sum(r["traced_prompts"])
