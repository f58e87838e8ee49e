"""The LM trainer (port of ``repro.launch.train``).

Wires together: config -> model -> AdamW -> TokenPipeline -> train_step
(grad accumulation, remat) -> CheckpointManager, on one device (``device``;
None: the GPU).

Fault tolerance, as in the reference:
  * periodic atomic checkpoints of (params, optimizer state) at the step
    count;
  * ``--resume`` restarts from the newest checkpoint, and because the data
    pipeline is seed-deterministic by (epoch, step), the token stream (and
    the stub frontend's frames or patches) continues exactly.

The reference's mesh (reshard-on-load over a device mesh) is not ported:
``mesh=`` raises ``NotImplementedError`` (``ROADMAP.md`` Queue A item 9.8).
``examples/lm_pretrain_torch.py`` calls :func:`train_loop`.

    python -m repro_torch.launch.train --arch seamless-m4t-medium \\
        --reduced --steps 10 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.tokens import SyntheticCorpus, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import enc_dec_split, get_model
from repro_torch.optim.adam import AdamConfig, AdamW


@dataclasses.dataclass
class TrainReport:
    losses: list
    step_times: list
    resumed_from: int = 0
    checkpoints: int = 0


def _stub_embeds(d: int, s: int):
    """The reference's builder of stub frontend embeddings (frames or
    patches) for the pipeline: seeded by (epoch, step)."""
    def build(epoch, step, a, b):
        rng = np.random.default_rng(epoch * 1_000_003 + step)
        return rng.standard_normal((a, b, s, d)).astype(np.float32)
    return build


def _pipeline(cfg, corpus: SyntheticCorpus, batch: int, seq_len: int,
                  accum: int) -> TokenPipeline:
    """The family's batch layout: enc-dec frames + tokens, VLM patches +
    tokens, or tokens alone."""
    if cfg.encoder_layers > 0:
        s_enc, s_dec = enc_dec_split(cfg, seq_len)
        return TokenPipeline(corpus, batch, s_dec, accum=accum, extra_builders={
            "frame_embeds": _stub_embeds(cfg.d_model, s_enc)})
    if cfg.frontend == "vision":
        p = min(cfg.frontend_tokens, max(seq_len - 1, 1))
        return TokenPipeline(corpus, batch, seq_len - p, accum=accum,
                             extra_builders={
                                 "patch_embeds": _stub_embeds(cfg.d_model, p)})
    return TokenPipeline(corpus, batch, seq_len, accum=accum)


def train_loop(cfg, *, steps: int, batch: int, seq_len: int,
               mesh=None, lr: float = 3e-4, seed: int = 0,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               resume: bool = False, log_every: int = 10,
               device=None) -> TrainReport:
    """Train ``cfg`` for ``steps`` steps (from the newest checkpoint under
    ``ckpt_dir`` when ``resume``); returns the losses and step times of the
    steps run here.  A step's time runs from its batch's upload to its
    loss on the host."""
    if mesh is not None:
        raise NotImplementedError(
            "the LM trainer on a mesh is not ported yet (ROADMAP.md Queue A "
            "item 9.8)")
    dev = resolve_device(device)
    model = get_model(cfg)
    opt = AdamW(AdamConfig(lr=lr, clip_norm=1.0))
    train_step = make_train_step(model, opt)
    accum = max(cfg.grad_accum, 1)

    params = model.init(seed, device=dev)
    opt_state = opt.init(params)
    mgr = CheckpointManager(ckpt_dir, every=ckpt_every) if ckpt_dir else None
    start = 0
    if mgr and resume:
        (params, opt_state), start, _ = mgr.restore_or_init(
            (params, opt_state), device=dev)

    pipe = _pipeline(cfg, SyntheticCorpus(cfg.vocab_size, seed=seed),
                         batch, seq_len, accum)
    report = TrainReport([], [], resumed_from=start)
    for step, host_batch in enumerate(pipe.epoch(0, steps, start_step=start),
                                      start=start):
        t0 = time.perf_counter()
        dev_batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in host_batch.items()}
        params, opt_state, loss = train_step(params, opt_state, dev_batch)
        loss = float(loss)          # waits for the step, its update included
        report.losses.append(loss)
        report.step_times.append(time.perf_counter() - t0)
        if mgr:
            saved = mgr.maybe_save(step + 1, (params, opt_state),
                                   extra={"seq_len": seq_len, "batch": batch})
            if saved:
                report.checkpoints += 1
        if log_every and step % log_every == 0:
            print(f"step {step}: loss {loss:.4f} "
                  f"({report.step_times[-1] * 1e3:.0f} ms)", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (small widths, f32)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    report = train_loop(cfg, steps=args.steps, batch=args.batch,
                        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                        resume=args.resume, device=args.device)
    print(f"final loss: {report.losses[-1]:.4f}  "
          f"mean step: {np.mean(report.step_times[1:]) * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
