"""Device choice and float32 numerics of the engine."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card. Without one, that and any CUDA device
    raise: the port never falls back to the CPU unless the caller passes
    device="cpu"."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def use_full_f32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions (cuDNN defaults to
    TF32, whose ~3 decimal digits would put the plain stages ~1e-3 away from
    the float32 reference before any kernel is involved). Process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
