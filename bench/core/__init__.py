"""The harness's own code: the harness, traffic, weights, trace reduction,
statistics and the frozen formulas of work. Nothing here imports ``jax``
or the JAX package; ``program.py`` alone imports the port
(``repro_torch``)."""
