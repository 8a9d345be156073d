"""The benchmark's CPU tests: run from the root of the repository with
`python -m pytest portbench/tests -q`. They need no card."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
