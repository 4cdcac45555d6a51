"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell's step for 512 forced host devices.  The port compiles nothing and
forces no device count: for every supported cell it

  1. starts a fake world of the mesh's ranks (``launch.mesh.fake_world``:
     a ``fake`` process group, this process rank 0) and builds the
     reference's production mesh in it,
  2. builds the cell's policy, the weights (and for train AdamW's state,
     int8 moments above 100e9 parameters) as fake DTensors on its
     shardings, and the inputs, as the trainer and the sharded serving
     steps hold them (``launch.costmodel.step_setup``),
  3. runs the whole step once under ``launch.hlo_analysis.StepTrace`` on
     fake tensors: rank 0's FLOPs, bytes accessed, collectives and peak
     live bytes, and the kernels' fake launches,
  4. builds the roofline from that trace's FLOPs and collective bytes and
     from ``launch.memmodel``'s memory term, on the H100's ``HW``,

and writes the reference's record to
``results/dryrun_torch/<arch>__<shape>__<mesh><suffix>.json`` (never the
reference's ``results/dryrun/``).  ``lower_s`` is the set-up's seconds,
``compile_s`` the traced step's, ``hlo_len`` the number of operations
it ran; ``memory_analysis`` holds the traced peak as ``argument`` (the
inputs) plus ``temp`` bytes, so ``hbm_per_device_bytes`` is that peak.

The reference composes its FLOPs from a stub, one period and the tail
because XLA counts a scan's body once; the port's eager trace counts
every layer, so its whole step is the total (``cost_source``
``"whole_step"``).  ``--composed`` adds the breakdown
(``launch.costmodel.composed_cost``, a second trace of the pieces) as the
record's ``composed``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # every cell, both meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod --out /tmp/records

The reference's environment switches are flags here: ``--kv-quant``
(``REPRO_KV_QUANT``), ``--suffix`` (``REPRO_CELL_SUFFIX``) and
``--skip-masked-blocks`` (``REPRO_ATTN_UNROLL_SKIP``: K3 and K3b counted
by the key tiles they run).  ``REPRO_ATTN_CHUNK`` has none: it sets the
chunks of the reference's XLA attention, and K3's tiles are fixed
(ROADMAP.md, P14).  Runs on the CPU or beside a card alike; it touches no
device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path

from repro_torch.serving.profiles import DRYRUN_DIR as RESULTS

MESHES = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}


def _opt_cfg(cfg):
    from repro_torch.training.optimizer import OptimizerConfig

    # int8 moments for the 400B MoE, as the reference's dry run sets them.
    return OptimizerConfig(quantize_moments=cfg.param_count() > 100e9)


def dry_run(cfg, shape, mesh_shape: dict, *, composed: bool = False) -> dict:
    """One cell's record without status, file or timings of its own: the
    whole step traced on a fake world of ``mesh_shape`` ({axis: size}, in
    mesh order), under the caller's ``models.attention.attention_options``
    (recorded); ``composed`` adds ``composed_cost``'s breakdown."""
    from repro_torch import kernels
    from repro_torch.distributed.policies import make_policy
    from repro_torch.launch.costmodel import composed_cost, fake_mode, step_setup, trace
    from repro_torch.launch.hlo_analysis import roofline_terms
    from repro_torch.launch.memmodel import analytic_hbm_bytes, roofline_fraction_for
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models.attention import _attn_opts

    opts = _attn_opts()
    n_dev = math.prod(mesh_shape.values())
    rec: dict = {"attention_options": {"unroll": opts["unroll"],
                                       "skip_masked_blocks": opts["skip"]}}
    with fake_world(n_dev):
        mesh = make_mesh(tuple(mesh_shape.values()), tuple(mesh_shape))
        policy = make_policy(cfg, shape.step, mesh)
        opt_cfg = _opt_cfg(cfg) if shape.step == "train" else None
        t0 = time.time()
        with fake_mode():
            fn, args, inputs = step_setup(cfg, shape, mesh, policy, opt_cfg)
            t_lower = time.time()
            kernels.reset_launch_counts()
            whole = trace(fn, args, inputs)
            del fn, args, inputs
        t_compile = time.time()
        rec["launches"] = {k: v for k, v in kernels.fake_launch_counts().items() if v}
        if composed:
            rec["composed"] = composed_cost(cfg, shape, mesh, policy, opt_cfg,
                                            skip_masked_blocks=opts["skip"])
    if opt_cfg is not None:
        rec["opt_quantized_moments"] = opt_cfg.quantize_moments
    rec["lower_s"] = round(t_lower - t0, 2)
    rec["compile_s"] = round(t_compile - t_lower, 2)
    rec["memory_analysis"] = {
        "argument_size_in_bytes": whole["start_bytes"],
        "output_size_in_bytes": 0,
        "temp_size_in_bytes": whole["peak_bytes"] - whole["start_bytes"],
        "alias_size_in_bytes": 0,
        "generated_code_size_in_bytes": 0,
    }
    rec["hbm_per_device_bytes"] = whole["peak_bytes"]
    rec["cost_analysis"] = {"flops": whole["flops"], "bytes accessed": whole["bytes"]}
    rec["collectives"] = whole["collectives"]
    rec["hlo_len"] = whole["ops"]
    rec["cost_source"] = "whole_step"
    flops_dev = whole["flops"]
    mem_model = analytic_hbm_bytes(cfg, shape, mesh_shape,
                                   opt_quantized=rec.get("opt_quantized_moments", False))
    rec["hbm_traffic_model"] = mem_model
    rec["hlo_bytes_accessed_upper_bound"] = whole["bytes"]
    rec["roofline"] = roofline_terms(flops_dev, mem_model["total"],
                                     float(whole["collectives"]["total_bytes"]))
    tokens = shape.global_batch * (shape.seq_len if shape.step != "decode" else 1)
    model_flops = cfg.model_flops_per_token() * tokens
    if shape.step != "train":
        model_flops /= 3.0  # fwd only: 2N per token instead of 6N
    rec["model_flops_total"] = model_flops
    rec["model_flops_per_device"] = model_flops / n_dev
    rec["useful_flops_ratio"] = (model_flops / n_dev) / flops_dev if flops_dev else 0.0
    rec["roofline"].update(roofline_fraction_for(
        shape.step, rec["roofline"]["t_compute_s"], rec["roofline"]["t_memory_s"],
        rec["roofline"]["t_collective_s"],
        useful_flops_frac=min(rec["useful_flops_ratio"], 1.0) or 1.0))
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, force: bool = False, *,
             out_dir=None, kv_quant: bool = False, suffix: str = "",
             skip_masked_blocks: bool = False, composed: bool = False) -> dict:
    """Trace one cell and write its record (a cached record is returned
    unless ``force``).  Skipped and failed cells are written too."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, cell_supported
    from repro_torch.models.attention import attention_options

    cfg = get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    shape = SHAPES[shape_name]
    out_path = Path(out_dir or RESULTS) / f"{cfg.name}__{shape_name}__{mesh_kind}{suffix}.json"
    ok, reason = cell_supported(cfg.name, shape_name)
    if not ok:
        rec = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
               "status": "skipped", "reason": reason}
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    mesh_shape = MESHES[mesh_kind]
    t0 = time.time()
    rec = {
        "arch": cfg.name, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(mesh_shape), "step": shape.step,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
    }
    if skip_masked_blocks:
        rec["attn_impl"] = "unrolled_causal_skip"
    try:
        # The reference's REPRO_ATTN_UNROLL_SKIP sets both options.
        with attention_options(unroll=skip_masked_blocks, skip_masked_blocks=skip_masked_blocks):
            rec.update(dry_run(cfg, shape, mesh_shape, composed=composed))
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import SHAPES

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", action="append", help="arch id (repeatable; default all)")
    ap.add_argument("--shape", action="append", help="shape name (repeatable; default all)")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="both")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--list", action="store_true", help="list cells and exit")
    ap.add_argument("--out", default=None, help=f"record directory (default {RESULTS})")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV caches")
    ap.add_argument("--suffix", default="", help="suffix of the record files")
    ap.add_argument("--skip-masked-blocks", action="store_true",
                    help="count the key tiles K3 and K3b run, not the full square")
    ap.add_argument("--composed", action="store_true",
                    help="add the stub / period / tail breakdown (a second trace)")
    args = ap.parse_args(argv)

    archs = args.arch or list(ARCHS)
    shapes = args.shape or list(SHAPES)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    if args.list:
        for c in cells:
            print(*c)
        return 0

    failures = 0
    for arch, shape_name, mesh_kind in cells:
        rec = run_cell(arch, shape_name, mesh_kind, force=args.force, out_dir=args.out,
                       kv_quant=args.kv_quant, suffix=args.suffix,
                       skip_masked_blocks=args.skip_masked_blocks, composed=args.composed)
        status = rec.get("status")
        if status == "ok":
            rt = rec["roofline"]
            print(
                f"[ok]   {arch:26s} {shape_name:12s} {mesh_kind:8s} "
                f"trace={rec.get('compile_s', 0):7.1f}s "
                f"hbm/dev={rec.get('hbm_per_device_bytes', 0)/2**30:7.2f}GiB "
                f"bound={rt['bound']:<10s} frac={rt['roofline_fraction']:.3f}",
                flush=True,
            )
        elif status == "skipped":
            print(f"[skip] {arch:26s} {shape_name:12s} {mesh_kind:8s} {rec['reason']}", flush=True)
        else:
            failures += 1
            print(f"[FAIL] {arch:26s} {shape_name:12s} {mesh_kind:8s} {rec.get('error')}",
                  flush=True)
    if failures:
        print(f"{failures} cells failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
