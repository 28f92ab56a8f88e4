"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of the checkout (the cases marked ``card`` skip without a CUDA card).
They import the harness (``bench``) and, where they drive the program, the
port from ``src/``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def cuda_device():
    """The card, where there is one; the test skips without it."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
