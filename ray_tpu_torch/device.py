"""The port's device rule: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``, and raises when no GPU is present — the port
    never drops to the CPU quietly.  Any device the caller names is taken
    as asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def dtype_of(name: str) -> torch.dtype:
    """Config dtype string (``"bfloat16"``, ``"float32"``) → torch dtype."""
    dt: Optional[torch.dtype] = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
