"""Named variants of the three selected cells: the port of
:mod:`repro.launch.hillclimb`, on :func:`repro_torch.launch.dryrun.run_cell`.

Cells (the reference's selection):

- lear-msn1 / rank_xl      — the paper's own technique: the compacted
  cascade IS the optimization; baseline = full scoring (paper's "Full").
- qwen2.5-14b / train_4k   — the most representative large-LM training
  cell.
- nequip / ogb_products    — the worst roofline cell, 61.8M-edge
  full-graph training.

Each variant is a config override; the cell is traced again and its
roofline recorded to ``artifacts/perf/``. The variants and labels are the
reference's. Importing this module sets no environment variable.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A|B|C]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_config

ART = os.path.join(os.path.dirname(__file__), "../../../artifacts/perf")


def variants():
    lear = get_config("lear-msn1")
    qwen = get_config("qwen2.5-14b")
    neq = get_config("nequip")
    r = dataclasses.replace
    return {
        "A": [
            ("lear-msn1", "rank_xl", lear,
             "A0-full-reference (paper 'Full': every doc × every tree)"),
            ("lear-msn1", "rank_xl", r(lear, capacity_frac=0.25),
             "A1-paper-compacted (LEAR cascade, per-query capacity 25%)"),
            ("lear-msn1", "rank_xl",
             r(lear, capacity_frac=0.25, sentinel2=150, capacity2_frac=0.08),
             "A2-two-sentinel (beyond-paper: second cut at tree 150, 8%)"),
            ("lear-msn1", "rank_xl",
             r(lear, capacity_frac=0.20, sentinel2=100, capacity2_frac=0.05),
             "A3-aggressive (cap 20%, second cut at 100, 5%)"),
        ],
        "B": [
            ("qwen2.5-14b", "train_4k", qwen, "B0-baseline"),
            ("qwen2.5-14b", "train_4k", r(qwen, embed_onehot=True),
             "B1-embed-onehot (kill involuntary remat on vocab-sharded gather)"),
            ("qwen2.5-14b", "train_4k",
             r(qwen, embed_onehot=True, causal_skip=True),
             "B2-causal-skip (+upper-triangle attention never computed)"),
            ("qwen2.5-14b", "train_4k",
             r(qwen, embed_onehot=True, causal_skip=True, remat_policy="dots"),
             "B3-remat-dots (save matmul outputs; trade memory for recompute)"),
            ("qwen2.5-14b", "train_4k",
             r(qwen, causal_skip=True, seq_parallel=True),
             "B4-seq-parallel (Megatron-SP residual: TP ARs → RS+AG, "
             "norm/residual work seq-sharded)"),
        ],
        "C": [
            ("nequip", "ogb_products", neq, "C0-baseline (f32 messages)"),
            ("nequip", "ogb_products", r(neq, dtype="bfloat16"),
             "C1-bf16-messages (halve per-edge tensors and node all-reduce)"),
            ("nequip", "ogb_products", r(neq, premix_messages=True),
             "C2-premix (channel-mix per edge before segment-sum: AR payload "
             "1120→288 floats/node by linearity)"),
            ("nequip", "ogb_products",
             r(neq, premix_messages=True, dtype="bfloat16"),
             "C3-premix-bf16 (compound; AR still f32 per XLA scatter "
             "semantics but gathers halve)"),
        ],
    }


def main(argv: list[str] | None = None) -> None:
    from repro_torch.launch import dryrun

    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    p.add_argument("--cell", choices=["A", "B", "C"], default=None)
    args = p.parse_args(argv)

    out_dir = os.path.normpath(ART)
    os.makedirs(out_dir, exist_ok=True)
    todo = variants()
    cells = [args.cell] if args.cell else list(todo)
    for cell in cells:
        for arch, shape, cfg, label in todo[cell]:
            tag = label.split(" ")[0]
            path = os.path.join(out_dir, f"{tag}.json")
            if os.path.exists(path):
                print(f"[skip-cached] {tag}")
                continue
            print(f"[perf] {tag}: {label}", flush=True)
            try:
                record, _ = dryrun.run_cell(arch, shape, multi_pod=False, override_cfg=cfg)
                record["label"] = label
            except Exception as e:  # noqa: BLE001 — record and continue
                record = {"label": label, "error": f"{type(e).__name__}: {e}"}
                print(f"  FAILED: {record['error']}")
            with open(path, "w") as f:
                json.dump(record, f, indent=1)
            if "roofline" in record:
                ro = record["roofline"]
                print(
                    f"  compute={ro['compute_s']:.3e} memory={ro['memory_s']:.3e} "
                    f"coll={ro['collective_s']:.3e} dominant={ro['dominant']} "
                    f"useful={ro['useful_ratio']:.2f}", flush=True,
                )


if __name__ == "__main__":
    main()
