"""Device selection and numeric settings shared by the entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def seeded_generator(device: torch.device | str, seed: int, *streams: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and the stream numbers
    (one stream per request, case or sample)."""
    value = seed
    for stream in streams:
        value = value * 1_000_003 + stream
    return torch.Generator(device=device).manual_seed(value % (1 << 63))


def set_full_precision_matmul() -> None:
    """Float32 products in full float32 (no TF32) and bf16 products with
    float32 reductions, as the JAX reference computes them on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
