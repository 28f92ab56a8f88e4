"""The paper's own "architecture": the VAI (Variable Arithmetic Intensity)
roofline-tracing benchmark suite (Algorithm 1) plus the memory-chunk bandwidth
probe. Drives the CUDA kernels in ``repro_torch.kernels`` through the sweep
in ``repro_torch.core.vai``."""
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class VAISuiteConfig:
    name: str = "paper-vai"
    family: str = "benchmark"
    # Arithmetic intensities swept (flops/byte), paper Fig. 4: 1/16 .. 1024,
    # powers of two, plus AI=0 (stream copy).
    intensities: Tuple[float, ...] = tuple(
        [0.0] + [2.0 ** e for e in range(-4, 11)])
    # Frequency grid (MHz) — paper Fig. 4/5 left column.
    frequencies_mhz: Tuple[int, ...] = (1700, 1500, 1300, 1100, 900, 700)
    # Power caps (W) — paper Fig. 4/5 right column.
    power_caps_w: Tuple[int, ...] = (560, 500, 400, 300, 200, 140, 100)
    # Memory-probe chunk sizes (bytes): 384 KB doubling past the L2
    # boundary, paper Fig. 6.
    chunk_sizes: Tuple[int, ...] = tuple(384 * 1024 * (2 ** i) for i in range(10))
    elements: int = 1 << 20       # work-items per sweep point (small default)
    repeat: int = 4


CONFIG = VAISuiteConfig()
