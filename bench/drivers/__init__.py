"""One driver a kind of traffic (``bench/traffic/<mix>.json``'s ``kind``):
``<kind>.py`` with ``run(cell, seed, seconds, trace, device, control)``."""
