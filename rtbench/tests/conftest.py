"""rtbench's tests run on the CPU at sizes it holds; the `cuda` ones decide inside
the test whether a card is there. Run: python -m pytest rtbench/tests -q"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(2)
