"""Train a ~100M-parameter dense LM on the PyTorch port, with
checkpoint/restart mid-run (the fault-tolerance path, exercised for real),
as ``examples/train_lm.py`` on ``repro_torch``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]           # on the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --smoke

A rerun resumes from the latest checkpoint in ``--ckpt-dir``
(``artifacts/torch_lm_demo``); ``--smoke`` trains a 2-layer model in a
fresh temporary directory, then restores its last checkpoint into a new
state and checks it equals the trained one.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import transformer as tfm
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import adamw
from repro_torch.train.trainer import init_state, make_train_step
from repro_torch.utils import resolve_device, tree_items

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts", "torch_lm_demo")


def small_lm() -> TransformerConfig:
    # ~103M params: 10 layers × d640 (62M body) + 32k vocab (41M embeddings).
    return TransformerConfig(
        name="demo-100m", n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
        d_head=64, d_ff=2560, vocab_size=32000, rope_theta=10000.0,
        attn_q_block=128, attn_kv_block=128,
    )


def tiny_lm() -> TransformerConfig:
    return TransformerConfig(
        name="demo-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=256, vocab_size=512, rope_theta=10000.0,
        attn_q_block=32, attn_kv_block=32, dtype="float32",
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--ckpt-dir", default=ART)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--smoke", action="store_true",
                   help="a 2-layer model, 40 steps of 4 x 32, a fresh checkpoint directory")
    args = p.parse_args()
    dev = resolve_device(args.device)
    scratch = None
    if args.smoke:
        cfg, lr = tiny_lm(), 3e-3
        args.steps, args.batch, args.seq, args.ckpt_every = 40, 4, 32, 20
        scratch = tempfile.TemporaryDirectory()
        args.ckpt_dir = scratch.name
    else:
        cfg, lr = small_lm(), 3e-4

    n_params = sum(x.numel() for x in tfm.abstract_params(cfg).values())
    print(f"model: {cfg.name}, {n_params / 1e6:.1f}M params")

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch_size=args.batch,
                         seq_len=args.seq, seed=0)
    opt = adamw(lr=lr)
    step_fn = make_train_step(lambda params, batch: tfm.loss_fn(cfg, params, batch), opt)

    # Restart-aware: resume from the latest checkpoint if one exists.
    state = init_state(tfm.init(cfg, 0, dev), opt)
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        state, extra = restore_checkpoint(args.ckpt_dir, state)
        pipe.restore(extra["pipeline"])
        start = int(extra["step"])
        print(f"restored checkpoint at step {start}; pipeline cursor "
              f"{pipe.cursor}")

    losses = []
    for i in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in pipe.next_batch().items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % 20 == 0:
            print(f"step {i + 1:4d}  loss {np.mean(losses[-20:]):.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):.3f}")
        if (i + 1) % args.ckpt_every == 0:
            path = save_checkpoint(
                args.ckpt_dir, i + 1, state,
                extra={"step": i + 1, "pipeline": pipe.state()},
            )
            print(f"checkpoint → {os.path.basename(path)}")

    if losses:
        print(f"\nfirst-20 mean loss {np.mean(losses[:20]):.4f} → "
              f"last-20 mean loss {np.mean(losses[-20:]):.4f}")
    if len(losses) >= 40:  # loss-drop check needs disjoint windows
        assert np.mean(losses[-20:]) < np.mean(losses[:20]), "loss did not drop"
    if scratch is not None:   # the restart path: a new state from the last checkpoint
        fresh = init_state(tfm.init(cfg, 1, dev), opt)
        back, extra = restore_checkpoint(args.ckpt_dir, fresh)
        want = dict(tree_items(state))
        same = all(torch.equal(t, want[k]) for k, t in tree_items(back))
        print(f"restored step {extra['step']} into a new state: equal to the trained one {same}")
        assert same, "the restored state differs"
        scratch.cleanup()


if __name__ == "__main__":
    main()
