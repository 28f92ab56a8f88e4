"""Hand-written CUDA kernels for the paper's two GPU benchmarks.

Only the pure cost-model helpers are re-exported here; the kernels
themselves stay behind their submodules (``repro_torch.kernels.vai`` etc. —
callers import the submodules by these same names, so the package namespace
must not shadow them with the functions). Importing this package builds
nothing: the CUDA sources under ``csrc/`` are compiled at the first launch
(:mod:`repro_torch.kernels.build`)."""
from repro_torch.kernels.membw import membw_bytes
from repro_torch.kernels.vai import vai_flops_bytes

__all__ = ["membw_bytes", "vai_flops_bytes"]
