"""Device resolution shared by the port's public entry points.

Every entry point that creates tensors (ensemble constructors, the ranking
service, the calibration probe) takes an explicit ``device``. ``None`` means
the card: the port is written for one CUDA device, and a run that finds no
card fails instead of quietly scoring on the CPU. The CPU path (the plain
PyTorch version of every kernel) is taken only when the caller asks for it
with ``device="cpu"``, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is requested and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default when no "
            "device is given) but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and dev.index is None:
        # Concrete index, so it compares equal to the device of its tensors.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
