"""Multi-pod dry-run (port of ``repro.launch.dryrun``).

For every (architecture x input shape) cell, build this rank's view of the
production mesh (single-pod 16x16 = 256 ranks, multi-pod 2x16x16 = 512)
over an in-process ``fake`` world (``launch/mesh.py::dryrun_mesh``), run
rank 0's REAL ``train_step`` / ``serve_step`` / ``prefill_step`` on
``meta`` tensors of its local shapes (zero allocation, no device work),
and record:

  * the argument bytes per device (parameters + optimizer state, or
    parameters + decode state, under the production plans) and the peak
    bytes the step allocates — proof the cell fits in 80 GB;
  * FLOPs and bytes of the step, counted op by op
    (``roofline/analysis.py::StepCounter``);
  * every collective the step issues (``launch/collectives.py``'s
    recorder) and its ring wire bytes;
  * the 3-term roofline at the H100 (``roofline/analysis.py``).

Where the reference lowers and compiles, this module executes eagerly,
so every layer runs and is counted: the reference's affine probes (two
unrolled compiles per cell, extrapolated to the real depth, because
``cost_analysis`` counts a scan body once) become one counted run,
recorded as ``probe_mode: "executed"``.  As in the reference, the counted
run is at ``grad_accum=1`` over the full global batch, and the f32
accumulator's traffic for ``grad_accum > 1`` is added analytically
(``accum_bytes_correction``); the bytes term comes from a second run
under ``linear_attention_traffic`` (``kernels/probe_ctx.py``) where
multi-token attention runs.  The record keeps the reference's keys,
except that ``lower_s``, ``compile_s`` and ``hlo_bytes`` become
``count_s`` (the counted run's wall time).  ``--multipod`` cells run the
step with no counts, the shard proof alone, as in the reference.

Records go to ``build/dryrun_torch/<cell>.json`` (gitignored) so an
interrupted sweep resumes.  A cell that raises is a bug in the port: the
sweep reports it and exits nonzero.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.kernels.probe_ctx import linear_attention_traffic
from repro_torch.launch.collectives import recording
from repro_torch.launch.mesh import dryrun_mesh
from repro_torch.launch.sharding import arch_scope, map_with_path, use_mesh
from repro_torch.launch.specs import (input_specs, local_structs,
                                      opt_state_shardings)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step, mesh_layout)
from repro_torch.models.lm import get_model
from repro_torch.models.scan_util import tree_leaves
from repro_torch.optim.adam import AdamConfig, AdamW
from repro_torch.roofline.analysis import (H100_SXM, StepCounter,
                                           collective_bytes, roofline_terms)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"


def _param_counts(structs, cfg) -> tuple[float, float]:
    """(total, active) param counts from the param structs (exact)."""
    total = expert = 0.0

    def visit(path, leaf):
        nonlocal total, expert
        n = float(leaf.numel())
        total += n
        if "experts_" in path:
            expert += n
        return leaf

    map_with_path(visit, structs)
    active = total
    if cfg.moe is not None and expert:
        active = total - expert * (1.0 - cfg.moe.top_k / cfg.moe.num_experts)
    return total, active


def _sharded_bytes(structs, plans) -> float:
    """Per-device bytes of a struct tree under its plans (the optimizer's
    step and the decode position, host ints here, count as the int32
    scalars the reference holds them in)."""
    total = 0.0
    for leaf, plan in zip(tree_leaves(structs), tree_leaves(plans)):
        if not isinstance(leaf, torch.Tensor):
            total += 4.0     # a host int (step, pos): the reference's int32
            continue
        n = leaf.element_size()
        for dim in leaf.shape:
            n *= dim
        shard = 1
        for axes in plan.dims:
            for a in axes:
                shard *= plan.mesh.shape[a]
        total += n / shard
    return total


VARIANTS = {
    # the reference's hillclimb variants; applied by name with '+'
    "pure_dp": lambda c: dataclasses.replace(c, pure_dp=True, fsdp=True),
    "chunked_ce": lambda c: dataclasses.replace(c, chunked_ce=512),
    "mlstm_chunk": lambda c: dataclasses.replace(
        c, xlstm=dataclasses.replace(c.xlstm, chunk=256)),
    "accum4": lambda c: dataclasses.replace(c, grad_accum=4),
    "grad_cast": lambda c: dataclasses.replace(c, bf16_grad_stream=True),
    "bf16_moments": lambda c: c,     # moment dtype handled via CLI flag
}


def apply_variant(cfg, variant: str):
    for name in variant.split("+"):
        if name:
            cfg = VARIANTS[name](cfg)
    return cfg


def _mesh_name(shape) -> str:
    return "x".join(str(s) for s in shape)


def cell_step(cfg, shape, mesh, opt_moment_dtype: str,
               device="meta") -> tuple:
    """(run(), arg bytes per device, n_total, n_active, the step's
    arguments) of one cell on this rank: ``run`` executes the real step
    on ``meta`` tensors of the local shapes, or on zeros on ``device``
    (the same ops: the tests and the calibration run it on real ranks;
    the caller scopes the mesh)."""
    model = get_model(cfg)
    specs = input_specs(cfg, shape, mesh, model=model)
    p_structs, p_plans = specs["params"]
    n_total, n_active = _param_counts(p_structs, cfg)
    params = local_structs(p_structs, p_plans, device)
    if shape.kind in ("decode", "prefill"):
        t_struct, t_plan = specs["tokens"]
        s_structs, s_plans = specs["state"]
        state = local_structs(s_structs, s_plans, device)
        # decode: one token into a full cache (the step every later
        # position runs); prefill: the prompt from position 0
        state["pos"] = shape.seq_len - 1 if shape.kind == "decode" else 0
        tokens = local_structs(t_struct, t_plan, device)
        make = make_serve_step if shape.kind == "decode" \
            else make_prefill_step
        step = make(model, p_plans, mesh_layout(t_plan, s_plans))
        arg = (_sharded_bytes(p_structs, p_plans)
               + _sharded_bytes(s_structs, s_plans))
        args = (params, tokens, state)
        return (lambda: step(*args)), arg, n_total, n_active, args
    mdt = torch.bfloat16 if opt_moment_dtype == "bfloat16" else torch.float32
    opt = AdamW(AdamConfig(lr=3e-4, moment_dtype=mdt))
    o_structs = opt.init(p_structs)
    o_plans = opt_state_shardings(mesh, o_structs, p_plans)
    opt_state = local_structs(o_structs, o_plans, device)
    # counted at grad_accum=1 over the same global batch (module docstring)
    cfg1 = dataclasses.replace(cfg, grad_accum=1)
    model1 = get_model(cfg1)
    b_structs, b_plans = input_specs(cfg1, shape, mesh, model=model1)[
        "batch"]
    batch = local_structs(b_structs, b_plans, device)
    step = make_train_step(model1, opt, p_plans)
    arg = (_sharded_bytes(p_structs, p_plans)
           + _sharded_bytes(o_structs, o_plans))
    args = (params, opt_state, batch)
    return (lambda: step(*args)), arg, n_total, n_active, args


def count_step(run, mesh, linear: bool = False, sites: bool = False):
    """(counter, collective log) of one run of ``run()`` under the mesh,
    the counter and the recorder."""
    lin = linear_attention_traffic(linear)
    counter = StepCounter(sites=sites)
    with use_mesh(mesh), lin, recording() as log, counter:
        run()
    return counter, log


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_moment_dtype: str = "float32", probe: bool = True,
             variant: str = "", rank: int = 0, mesh_shape=None,
             cfg=None, hw=H100_SXM) -> dict:
    """One cell's record (module docstring).  ``mesh_shape`` overrides the
    production mesh (tests); ``cfg`` the arch's config (reduced ones)."""
    cfg = apply_variant(cfg or get_config(arch), variant)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh_shape = tuple(mesh_shape or ((2, 16, 16) if multi_pod
                                      else (16, 16)))
    mname = _mesh_name(mesh_shape)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mname,
                "status": "skipped", "reason": why}
    t0 = time.time()
    with dryrun_mesh(mesh_shape, rank) as mesh, arch_scope(cfg):
        chips = mesh.size
        run, arg_bytes, n_total, n_active, _ = cell_step(
            cfg, shape, mesh, opt_moment_dtype)
        # the multi-pod proof runs under the counter too, for its cache of
        # meta results (StepCounter._run), and records no counts
        counter, log = count_step(run, mesh)
        t_count, t_probe = time.time() - t0, 0.0
        byt = float(counter.bytes)
        if probe and shape.kind != "decode" and cfg.xlstm is None:
            t1 = time.time()
            byt = float(count_step(run, mesh, linear=True)[0].bytes)
            t_probe = time.time() - t1
        accum_bytes = 0.0
        accum = max(cfg.grad_accum, 1)
        if probe and shape.kind == "train" and accum > 1:
            # f32 grad accumulator read + write per extra microbatch
            accum_bytes = (accum - 1) * 2 * 4.0 * n_total / chips
            byt += accum_bytes
    coll = collective_bytes(log) if probe else None
    terms = (roofline_terms(float(counter.flops), byt, coll, cfg, shape,
                            chips, hw=hw, n_active=n_active)
             if probe else None)
    mem = {"argument_bytes": arg_bytes,
           "temp_bytes": counter.peak_bytes if probe else None,
           "output_bytes": None}
    peak = arg_bytes + (counter.peak_bytes if probe else 0)
    return {
        "arch": arch, "shape": shape.name, "mesh": mname, "rank": rank,
        "chips": chips, "status": "ok", "kind": shape.kind,
        "grad_accum": cfg.grad_accum,
        "params_total": n_total, "params_active": n_active,
        "arg_bytes_per_device": arg_bytes,
        "memory_analysis": mem,
        "peak_bytes_per_device": peak if probe else None,
        "fits_hbm": (peak <= hw.hbm_bytes) if probe else None,
        "hw": hw.name,
        "probe_mode": "executed" if probe else "skipped(multipod)",
        "cost_flops_per_device": float(counter.flops) if probe else None,
        "cost_bytes_per_device": byt if probe else None,
        "counted_bytes_executed": float(counter.bytes) if probe else None,
        "accum_bytes_correction": accum_bytes,
        "collectives": ({"calls": len(log), "result_bytes": sum(
            r["bytes"] for r in log)} if probe else None),
        "roofline": terms.as_dict() if probe else None,
        "count_s": round(t_count, 2), "probe_s": round(t_probe, 2),
    }


def cell_path(arch: str, shape_name: str, multi_pod: bool,
              variant: str = "", rank: int = 0) -> Path:
    mesh = "multi" if multi_pod else "single"
    tag = f"__{variant.replace('+', '_')}" if variant else ""
    rk = f"__rank{rank}" if rank else ""
    return RESULTS_DIR / f"{arch}__{shape_name}__{mesh}{tag}{rk}.json"


def _line(rec: dict) -> str:
    if rec["status"] == "ok" and rec.get("roofline"):
        r = rec["roofline"]
        return (f"  ok: dominant={r['dominant']} "
                f"compute={r['compute_s']:.4f}s "
                f"memory={r['memory_s']:.4f}s "
                f"collective={r['collective_s']:.4f}s "
                f"frac={r['roofline_fraction']:.3f} "
                f"arg_gb={rec['arg_bytes_per_device'] / 1e9:.2f} "
                f"peak_gb={rec['peak_bytes_per_device'] / 1e9:.2f} "
                f"fits={rec['fits_hbm']} (count {rec['count_s']}s)")
    if rec["status"] == "ok":
        return (f"  ok (shard proof only): "
                f"arg_gb={rec['arg_bytes_per_device'] / 1e9:.2f} "
                f"(run {rec['count_s']}s)")
    if rec["status"] == "skipped":
        return f"  skipped: {rec['reason']}"
    return "  FAILED"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true",
                    help="run the 2x16x16 mesh (default: single-pod 16x16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true", help="ignore cached cells")
    ap.add_argument("--moment-dtype", default=None,
                    help="override optimizer moment dtype (bfloat16 for MoE)")
    ap.add_argument("--variant", default="",
                    help="'+'-joined variant names (see VARIANTS)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the mesh position whose program is counted")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.multipod] if not args.both_meshes else [False, True]

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                path = cell_path(arch, shape_name, mp, args.variant,
                                 args.rank)
                if path.exists() and not args.force:
                    print(f"[cached] {path.name}")
                    continue
                label = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
                print(f"[run] {label}", flush=True)
                try:
                    mdt = args.moment_dtype or (
                        "bfloat16" if get_config(arch).fsdp else "float32")
                    rec = run_cell(arch, shape_name, mp, opt_moment_dtype=mdt,
                                   probe=not mp, variant=args.variant,
                                   rank=args.rank)
                except Exception:
                    failures.append(label)
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if mp else "16x16",
                           "variant": args.variant, "status": "failed",
                           "traceback": traceback.format_exc()}
                    print(rec["traceback"], file=sys.stderr)
                path.write_text(json.dumps(rec, indent=1))
                print(_line(rec), flush=True)
    if failures:
        print(f"\nFAILED cells ({len(failures)}):", *failures, sep="\n  ")
        return 1
    print("\nall requested cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
