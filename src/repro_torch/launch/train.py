"""Training launcher: mesh + sharding + fault-tolerant trainer for --arch,
the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --reduced \\
        --steps 200 --batch 8 --seq 64

``--mesh data,model=a,b`` trains with ZeRO-3 over a ``DeviceMesh`` of that
shape (``make_policy(cfg, "train", mesh)``'s shardings, ``Trainer(
shardings=)``), on ``--devices N`` ranks (N = a * b): one per card on
``cuda`` (the default), gloo ranks on ``--device cpu``.  The ranks are
processes this launcher spawns; they meet at a ``FileStore`` in the
checkpoint directory.  A mesh is always run through a process group,
one rank included (``data,model=1,1`` runs the sharded route on one
card).  The reference forces N host devices through ``XLA_FLAGS``; the
port sets no environment.  ``--devices`` above 1 needs ``--mesh``.
When a rank fails inside a step, where its peers cannot be told
(``training.trainer``), every rank is ended and all are started again
from the last checkpoint, at most ``TrainerConfig.max_restarts`` times.
Rank 0 prints; its last line is ``summary`` and a JSON object: every
step's loss and seconds, tokens/s at the median step, the peak device
memory (on the card), the bytes of its shards of the weights and AdamW's
state, and the kernel launches of its run.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--devices", type=int, default=0, help="ranks to start (one per card)")
    ap.add_argument("--mesh", default="", help='e.g. "data,model=4,2" (needs as many ranks)')
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def _mesh_arg(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    axes_s, dims_s = text.split("=")
    return tuple(int(x) for x in dims_s.split(",")), tuple(axes_s.split(","))


def _train(rank: int, args, world: int, store_path: str | None) -> None:
    """One rank's run (the whole run without a mesh)."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.device import resolve_device
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, Trainer, TrainerConfig
    from repro_torch.trees import tree_leaves

    device = resolve_device(args.device)
    if store_path is not None:
        if device.type == "cuda":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world)
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = LM(cfg)
        if rank == 0:
            print(f"arch={cfg.name} params={model.num_params():,} devices={world}", flush=True)
        opt_cfg = OptimizerConfig(learning_rate=args.lr, warmup_steps=max(args.steps // 20, 1),
                                  total_steps=args.steps)
        shardings = None
        if args.mesh:
            from repro_torch.distributed.policies import make_policy
            from repro_torch.distributed.sharding import named_sharding_tree
            from repro_torch.launch import shardings as shd
            from repro_torch.launch.mesh import make_mesh

            mesh = make_mesh(*_mesh_arg(args.mesh), device=device.type)
            policy = make_policy(cfg, "train", mesh)
            shardings = (named_sharding_tree(shd.param_pspecs(model, policy, mesh), mesh),
                         named_sharding_tree(shd.opt_state_pspecs(model, policy, mesh, opt_cfg),
                                             mesh))

        ds = LMDataset(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, kind="markov"))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        trainer = Trainer(
            model, ds, opt_cfg=opt_cfg,
            cfg=TrainerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                              checkpoint_dir=args.ckpt_dir, log_every=max(args.steps // 10, 1)),
            shardings=shardings, device=device,
        )
        step, params, opt, summary = trainer.train()
        state_bytes = sum(
            (x.to_local() if hasattr(x, "to_local") else x).nbytes
            for x in tree_leaves({"params": params.to_tree(), "opt": opt}))
        if rank == 0:
            print(f"done @ step {step}: restarts={summary['restarts']} "
                  f"stragglers={summary['stragglers']} "
                  f"losses={[round(l, 3) for l in summary['losses']]}")
            times = trainer.step_times
            print("summary " + json.dumps({
                "losses": summary["losses"], "step_s": times,
                "tokens_per_s": args.batch * args.seq / statistics.median(times),
                "peak_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None),
                "state_bytes": state_bytes,
                "launches": kernels.launch_counts()}), flush=True)
    finally:
        if store_path is not None:
            dist.destroy_process_group()


def _store_path(directory) -> str:
    """A new path in ``directory`` for a ``FileStore``, which starts from no file."""
    Path(directory).mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix=".rendezvous-", dir=directory)
    os.close(fd)
    os.unlink(path)
    return path


def run_ranks(fn, args: tuple, world: int, store_dir, restarts: int = 0) -> None:
    """``fn(rank, *args, world, store_path)`` on ``world`` spawned ranks
    that meet at a fresh ``FileStore`` in ``store_dir``.  When a rank
    fails, every rank is ended and all are started again, at most
    ``restarts`` times (a trainer resumes from its last checkpoint)."""
    import torch.multiprocessing as mp

    for attempt in range(restarts + 1):
        store_path = _store_path(store_dir)
        try:
            ctx = mp.start_processes(fn, args=(*args, world, store_path), nprocs=world,
                                     start_method="spawn", join=False)
            while not ctx.join(grace_period=5):
                pass
            return
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            if attempt == restarts:
                raise
            print(f"rank {e.error_index} failed; starting the {world} ranks again "
                  f"({attempt + 1} of {restarts})", file=sys.stderr, flush=True)
        finally:
            if os.path.exists(store_path):
                os.unlink(store_path)


def main(argv=None):
    args = _parse(argv)
    world = max(args.devices, 1)
    if world > 1 and not args.mesh:
        raise SystemExit("--devices above 1 needs --mesh: the ranks train one sharded model")
    if not args.mesh:
        _train(0, args, 1, None)
    elif world == 1:  # no peers: the trainer restores by itself
        store_path = _store_path(args.ckpt_dir)
        try:
            _train(0, args, 1, store_path)
        finally:
            if os.path.exists(store_path):
                os.unlink(store_path)
    else:
        from repro_torch.training import TrainerConfig

        run_ranks(_train, (args,), world, args.ckpt_dir, TrainerConfig().max_restarts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
