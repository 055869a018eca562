"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

The port of :mod:`repro.launch.serve`, on the smoke config, on the card
unless ``--device cpu``:

LM archs: prefill + greedy decode (``generate``, 2 prompts of 16 tokens,
8 steps). RecSys archs: batched scoring. Forest (lear-msn1): the LEAR
cascade cell, through the forest kernel.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.configs.base import ForestConfig, RecSysConfig, ShapeSpec, TransformerConfig
from repro_torch.models.api import make_cell
from repro_torch.models.synth import as_tensors, synthesize_inputs
from repro_torch.utils import resolve_device


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", choices=list_archs(), required=True)
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if isinstance(cfg, TransformerConfig):
        _serve_lm(cfg, args, dev)
    elif isinstance(cfg, RecSysConfig):
        _serve_recsys(cfg, args, dev)
    elif isinstance(cfg, ForestConfig):
        _serve_forest(cfg, args, dev)
    else:
        raise SystemExit(f"{cfg.name}: GNN potentials are trained, not served")


def _serve_lm(cfg, args, dev):
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.lm_serve import generate

    params = tfm.init(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32), device=dev
    )
    t0 = time.time()
    out = generate(cfg, params, prompt, n_steps=8).cpu().numpy()
    print(f"generated {out.shape} tokens in {time.time() - t0:.2f}s")
    print(out)


def _serve_recsys(cfg, args, dev):
    shape = ShapeSpec(name="cli_serve", kind="serve", batch=32)
    cell = make_cell(cfg, shape)
    params = cell.init_state(0, device=dev)
    for i in range(args.batches):
        scores = cell.step(params, as_tensors(synthesize_inputs(cell, seed=i), dev))
        print(f"batch {i}: scored {scores.shape[0]} requests, "
              f"mean={float(scores.mean()):+.3f}")


def _serve_forest(cfg, args, dev):
    shape = ShapeSpec(name="cli_rank", kind="serve", batch=4)
    cell = make_cell(cfg, shape)
    params = cell.init_state(0, device=dev)
    for i in range(args.batches):
        scores, cont = cell.step(params, as_tensors(synthesize_inputs(cell, seed=i), dev))
        rate = float(cont.float().mean())
        print(f"batch {i}: ranked {scores.shape[0]} queries, "
              f"continue rate {rate:.1%}")


if __name__ == "__main__":
    main()
