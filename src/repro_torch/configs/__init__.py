"""Benchmark configurations of the port (the paper's VAI suite)."""
from repro_torch.configs.paper_vai import CONFIG, VAISuiteConfig  # noqa: F401
