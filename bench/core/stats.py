"""The arithmetic of the end-to-end numbers, over every sample."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of all the samples (numpy's linear
    interpolation between the two nearest ranks)."""
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def share(part: float, whole: float) -> float:
    """``part / whole`` in percent."""
    if whole <= 0:
        raise ValueError(f"a share of {whole}")
    return 100.0 * part / whole

