"""The float type the reference computes in: float32, as the program does;
the control of the benchmark's comparison sets bfloat16 (set_dtype), the
next precision below."""

import torch

_dtype = torch.float32


def dtype() -> torch.dtype:
    return _dtype


def set_dtype(dt: torch.dtype):
    global _dtype
    _dtype = dt
