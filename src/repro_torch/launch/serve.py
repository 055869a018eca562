"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

The port of :mod:`repro.launch.serve`, on the smoke config, on the card
unless ``--device cpu``:

RecSys archs: batched scoring. Forest (lear-msn1): the LEAR cascade cell,
through the forest kernel. The LM archs raise until their slice lands
(``ROADMAP.md`` A7), as ``make_cell`` does.
"""

from __future__ import annotations

import argparse

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
        raise NotImplementedError(
            f"{cfg.name}: LM serving (prefill + decode) is not ported yet (ROADMAP.md A7)"
        )
    if isinstance(cfg, RecSysConfig):
        _serve_recsys(cfg, args, dev)
    elif isinstance(cfg, ForestConfig):
        _serve_forest(cfg, args, dev)
    else:
        raise SystemExit(f"{cfg.name}: GNN potentials are trained, not served")


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
