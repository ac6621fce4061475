"""The benchmark's own tests: CPU tests at small sizes, and `gpu` tests
(the lower-precision control at the cells' sizes) that skip without a card.

    python -m pytest lrpt_bench/tests -q             # here, on the CPU
    python -m pytest lrpt_bench/tests -q -m gpu -s   # on the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU machine")
    return torch.device("cuda", 0)
