"""The benchmark's tests run from the repository root with
``python -m pytest bench/tests``: the port and the harness go on the path
here."""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# the cells' CPU runs are timed windows: one thread each keeps parallel
# workers from starving one another's windows
torch.set_num_threads(1)
