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

  * **elastic**: the checkpoint holds unsharded leaves; on load they are
    sliced under the *current* mesh's plans, so a run can resume on
    another mesh, or on one device.

On a mesh (``mesh``: this rank's :class:`~repro_torch.launch.mesh.HostMesh`
of a ``(data, model)`` world that ``launch.mesh.run_ranks`` started; every
rank calls :func:`train_loop` alike), the parameters are drawn whole and
sliced to this rank's blocks under the reference's rule table
(``models.lm_params.shard_params``: tensor parallelism over ``model`` for
every family, heads for attention and the recurrent cells, expert
parallelism for the MoE configs' experts, ZeRO-3 over ``data`` where
``cfg.fsdp``), and the AdamW moments follow.
Data rank ``d`` of ``D`` takes rows ``[d·B/D, (d+1)·B/D)`` of each
(micro)batch, the ``[accum]`` dim whole; the step is the data-parallel one
of ``launch/steps.py``.  Every rank of a model group computes the same
loss; the losses reported are the global batch's.  Checkpoints gather
each leaf whole and the leader (global rank 0) writes them.
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
from repro_torch.launch.sharding import use_mesh
from repro_torch.launch.specs import batch_shardings, opt_state_shardings
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import enc_dec_split, get_model
from repro_torch.models.lm_params import shard_params
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


def _check_mesh(cfg, mesh, batch: int) -> None:
    """Refuse a batch the data axis does not split evenly."""
    rows = batch // max(cfg.grad_accum, 1)
    if rows % mesh.shape["data"]:
        raise ValueError(f"a batch of {rows} rows a microbatch does not "
                         f"split over {mesh.shape['data']} data ranks")


def _upload(host_batch: dict, mesh, dev) -> dict:
    """The step's batch on ``dev``: on a mesh, data rank d's rows
    ``[d·b/D, (d+1)·b/D)`` of each ``[accum, b, ...]`` leaf (the
    reference's batch plans)."""
    out = {k: torch.from_numpy(v) for k, v in host_batch.items()}
    if mesh is not None:
        plans = batch_shardings(mesh, out, accum_dim=True)
        out = {k: plans[k].local(v) for k, v in out.items()}
    return {k: v.to(dev) for k, v in out.items()}


def train_loop(cfg, *, steps: int, batch: int, seq_len: int,
               mesh=None, lr: float = 3e-4, seed: int = 0,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               resume: bool = False, log_every: int = 10,
               device=None) -> TrainReport:
    """Train ``cfg`` for ``steps`` steps (from the newest checkpoint under
    ``ckpt_dir`` when ``resume``), on one device or on a mesh (module
    docstring); returns the losses and step times of the steps run here.
    A step's time runs from its batch's upload to its loss on the host."""
    dev = resolve_device(device)
    if mesh is not None:
        _check_mesh(cfg, mesh, batch)
    model = get_model(cfg)
    opt = AdamW(AdamConfig(lr=lr, clip_norm=1.0))
    accum = max(cfg.grad_accum, 1)

    with use_mesh(mesh):
        params = model.init(seed, device=dev)
        plans = state_plans = None
        if mesh is not None:            # the full tree is dropped here
            params, plans = shard_params(params, mesh, cfg)
            state_plans = (plans, opt_state_shardings(mesh, None, plans))
        train_step = make_train_step(model, opt, plans)
        opt_state = opt.init(params)
        mgr = (CheckpointManager(ckpt_dir, every=ckpt_every) if ckpt_dir
               else None)
        start = 0
        if mgr and resume:
            (params, opt_state), start, _ = mgr.restore_or_init(
                (params, opt_state), device=dev, plans=state_plans)

        pipe = _pipeline(cfg, SyntheticCorpus(cfg.vocab_size, seed=seed),
                         batch, seq_len, accum)
        report = TrainReport([], [], resumed_from=start)
        for step, host_batch in enumerate(
                pipe.epoch(0, steps, start_step=start), start=start):
            t0 = time.perf_counter()
            dev_batch = _upload(host_batch, mesh, dev)
            params, opt_state, loss = train_step(params, opt_state, dev_batch)
            loss = float(loss)      # waits for the step, its update included
            report.losses.append(loss)
            report.step_times.append(time.perf_counter() - t0)
            if mgr:
                saved = mgr.maybe_save(step + 1, (params, opt_state),
                                       extra={"seq_len": seq_len,
                                              "batch": batch},
                                       plans=state_plans)
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
