"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of :mod:`repro.launch.train`. Runs the smoke config by default
and the full config with ``--full``, on the card unless ``--device cpu``.
The production loop: resumable pipeline (batch ``i`` is drawn from seed
``i``), periodic checkpointing, and the reference's watchdog: a step that
raises restores the last checkpoint and the loop goes on. A CUDA error, a
card out of memory, or a kernel that fails to build, load or launch is
never retried quietly: it ends the run.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.configs.base import NequIPConfig, RecSysConfig, ShapeSpec, TransformerConfig
from repro_torch.models.api import make_cell
from repro_torch.models.synth import as_tensors, synthesize_inputs
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.utils import resolve_device

# Words of the errors a device or kernel fault raises (torch's CUDA errors,
# repro_torch.kernels.build and the kernel wrappers).
_DEVICE_FAULTS = ("CUDA", "cuda", "nvcc", "forest kernel", "kernel library", "repro_torch: building")


def is_device_fault(exc: BaseException) -> bool:
    """Whether a failed step is the card's or a kernel's fault, which the
    watchdog must not retry."""
    if isinstance(exc, (torch.cuda.OutOfMemoryError, OSError)):
        return True
    return any(word in str(exc) for word in _DEVICE_FAULTS)


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--arch", choices=list_archs(), required=True)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--full", action="store_true",
                   help="use the full (not smoke) config")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    shape = _train_shape(cfg)
    cell = make_cell(cfg, shape)
    ckpt_dir = args.ckpt_dir or os.path.join("artifacts", "train", cfg.name)

    state = cell.init_state(0, device=dev)
    start = 0
    if latest_step(ckpt_dir) is not None:
        state, extra = restore_checkpoint(ckpt_dir, state)
        start = int(extra["step"])
        print(f"resumed from step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        batch = as_tensors(synthesize_inputs(cell, seed=i), dev)
        try:
            state, metrics = cell.step(state, batch)
        except Exception as e:  # noqa: BLE001 — watchdog path
            if is_device_fault(e):
                raise
            print(f"step {i} failed ({e}); restoring last checkpoint")
            state, extra = restore_checkpoint(ckpt_dir, state)
            continue
        if (i + 1) % 5 == 0:
            print(f"step {i + 1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"({(time.time() - t0) / (i + 1 - start):.2f}s/step)")
        if (i + 1) % args.ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, state, extra={"step": i + 1})
    print("done")


def _train_shape(cfg) -> ShapeSpec:
    if isinstance(cfg, TransformerConfig):
        return ShapeSpec(name="cli_train", kind="train", seq_len=64,
                         global_batch=8, microbatch=4)
    if isinstance(cfg, NequIPConfig):
        return ShapeSpec(name="cli_train", kind="train", n_nodes=64,
                         n_edges=192, graph_batch=4)
    if isinstance(cfg, RecSysConfig):
        return ShapeSpec(name="cli_train", kind="train", batch=64)
    raise SystemExit(f"{cfg.name} is not trainable here (the forests train through "
                     f"repro_torch.forest.lambdamart and repro_torch.core.lear.train_lear)")


if __name__ == "__main__":
    main()
