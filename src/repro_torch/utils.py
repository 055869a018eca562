"""Device resolution shared by the port's public entry points, and the
device timer of its measurement scripts.

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


# Cycles of the sleep kernel ahead of a timed run (about 50 ms at 1.98 GHz):
# longer than the host takes to enqueue the run's calls.
SLEEP_CYCLES = 100_000_000


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` on the current CUDA stream:
    ``reps`` back-to-back calls between one pair of CUDA events, divided by
    ``reps``, after ``warmup`` calls.

    A sleep kernel queued first keeps the card busy while the host enqueues
    the calls, so the window holds the calls' device work and the gaps
    between launches, not the host's call time.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
