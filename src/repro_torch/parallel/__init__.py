from repro_torch.parallel.executor import ShardedExecutor  # noqa: F401
