"""Mean length of the window's ticks that only decode (no admission), on
the host's clock, outside the traced part: ``ContinuousEngine
.generate_step`` with the scheduler's work around it."""


def read(r):
    if r["kind"] != "serve":
        return None
    d = [t.dur for t in r["ticks"] if not t.admitted and t.n_dec]
    return 1e3 * sum(d) / len(d) if d else None
