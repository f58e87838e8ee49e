"""LM pretraining over the LM zoo, on the PyTorch port.

The twin of ``examples/lm_pretrain.py`` over ``repro_torch``: the training
loop with grad accumulation, remat, checkpoint/restart and the
deterministic data pipeline, for the enc-dec and the dense / VLM
decoder-only archs (the others raise, naming their ROADMAP item).  It runs
on the GPU unless ``--device cpu`` is given; ``--reduced`` takes the same
family at smoke scale.

Run:  PYTHONPATH=src python examples/lm_pretrain_torch.py --arch gemma-2b \
          --reduced --steps 50 --device cpu [--ckpt-dir /tmp/ckpt --resume]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.train import train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seamless-m4t-medium",
                    choices=list_archs())
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} "
          f"(reduced={args.reduced})")

    rep = train_loop(cfg, steps=args.steps, batch=args.batch,
                     seq_len=args.seq_len, lr=args.lr,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     resume=args.resume, log_every=10, device=args.device)
    print(f"\nloss: {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} "
          f"({len(rep.losses)} steps, resumed from {rep.resumed_from})")
    print(f"mean step time: {np.mean(rep.step_times[1:]) * 1e3:.1f} ms; "
          f"checkpoints written: {rep.checkpoints}")
    if not rep.losses[-1] < rep.losses[0]:
        raise SystemExit("training did not reduce the loss")


if __name__ == "__main__":
    main()
