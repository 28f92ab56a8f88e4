"""The port's benchmark: one cell of ``BENCHMARK.json`` run once by
``python3 bench/run.py`` (see ``bench/README.md``)."""
