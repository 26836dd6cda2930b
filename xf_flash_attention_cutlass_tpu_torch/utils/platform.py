"""Device resolution and shape arithmetic.

The port has no interpret mode: which implementation runs is decided by the
device of the tensors a function is given. CUDA tensors launch the
hand-written kernels (or raise); CPU tensors run the plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def next_multiple(x: int, m: int) -> int:
    return cdiv(x, m) * m


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return dev


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The working precision of the plain versions for inputs of `dtype`:
    float32, or float64 for float64 inputs, so that a float64 run of the
    plain versions is a float64 oracle."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def is_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device. Mixed devices raise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) > 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    return kinds == {"cuda"}
