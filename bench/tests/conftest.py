"""The benchmark's CPU tests: the harness, its reference and its checks at
tiny sizes, with the port's plain kernel versions."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

torch.set_num_threads(2)            # parallel test workers share the cores
