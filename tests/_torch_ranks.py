"""Gloo ranks on the CPU for tests/test_torch_launch.py.

    python tests/_torch_ranks.py JOB.json

Starts ``world`` processes (spawned) that meet at a ``FileStore`` in the
job's directory, build a ``DeviceMesh`` of the job's (data, model) shape
and, for each reduced arch of the job:

  * restore the job's step-0 checkpoint (written by the reference's
    Trainer) onto the train policy's shardings, and write the largest
    difference between each local shard and the same shard cut from the
    unsharded restore;
  * take the first step's gradients through
    ``launch.steps.sharded_loss_and_grads`` and save them whole
    (``checkpoint.save``: every rank gathers, rank 0 writes);
  * resume ``Trainer(shardings=)`` from that checkpoint for the job's
    steps, and write the losses; its final checkpoint holds the weights;
  * resume it for two steps more with a fault injected at the second on
    every rank, then two more with it on rank 1 alone, and write each
    rank's step, restarts and faults fired;
  * take two steps with int8 moments sharded and unsharded from the same
    weights, and write the weights' largest difference;

then run three rounds of ``compressed_psum_tree`` over each mesh axis of
size above one on per-rank gradients seeded by rank, and write every
rank's outputs and error feedback.  Last, ``launch.train.run_ranks``
starts the ranks again for a sharded Trainer from the seed, in which
rank 1 fails inside a step once (``_step_fault_rank``).  Imports nothing
of the JAX package.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _rank(rank: int, job: dict) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    world = job["world"]
    dist.init_process_group("gloo", store=dist.FileStore(job["store"], world), rank=rank,
                            world_size=world)
    try:
        _work(rank, job)
    finally:
        dist.destroy_process_group()


def _work(rank: int, job: dict) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.distributed import fsdp
    from repro_torch.distributed.policies import make_policy
    from repro_torch.distributed.sharding import named_sharding_tree
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import sharded_loss_and_grads
    from repro_torch.models import LM
    from repro_torch.models.transformer import TransformerParams
    from repro_torch.training import OptimizerConfig, Trainer, TrainerConfig
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.compression import compressed_psum_tree, init_error_feedback
    from repro_torch.trees import tree_leaves

    out = Path(job["out"])
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"), device="cpu")
    result = {}
    for arch, ck_dir in job["archs"].items():
        cfg = get_config(arch).reduced()
        model = LM(cfg)
        policy = make_policy(cfg, "train", mesh)
        opt_cfg = OptimizerConfig(**job["opt"])
        p_sh = named_sharding_tree(shd.param_pspecs(model, policy, mesh), mesh)
        o_sh = named_sharding_tree(shd.opt_state_pspecs(model, policy, mesh, opt_cfg), mesh)
        restore_sh = {"params": p_sh, "opt": {**o_sh, "step": None}}
        data = LMDataset(LMDataConfig(**job["data"], vocab_size=cfg.vocab_size))
        state, _ = ckpt.restore(ck_dir, 0, shardings=restore_sh, device="cpu")
        full, _ = ckpt.restore(ck_dir, 0, device="cpu")
        cut = fsdp.shard_tree(full, restore_sh)
        shard_err = max(float((a.to_local().float() - b.to_local().float()).abs().max())
                        for a, b in zip(tree_leaves(state["params"]),
                                        tree_leaves(cut["params"])))
        placed = all(tuple(a.placements) == tuple(b.placements)
                     for a, b in zip(tree_leaves(state["opt"]["m"]),
                                     tree_leaves(cut["opt"]["m"])))
        params = TransformerParams(cfg, state["params"])
        batch = {k: torch.as_tensor(v) for k, v in data.batch_at(1).items()}
        loss, share, blocks, metrics, grads = sharded_loss_and_grads(model, params, batch,
                                                                     policy)
        ckpt.save(out / f"grads-{arch}", 0, grads)
        trainer = Trainer(model, data, opt_cfg=opt_cfg,
                          cfg=TrainerConfig(checkpoint_dir=ck_dir, **job["trainer"]),
                          shardings=(p_sh, o_sh), device="cpu")
        step, _, _, summary = trainer.train()
        # every rank's fault, then rank 1's alone, each restoring the last
        # checkpoint on every rank
        fault = _fault_restart(model, data, opt_cfg, ck_dir, (p_sh, o_sh), step, None)
        fault_one = _fault_restart(model, data, opt_cfg, ck_dir, (p_sh, o_sh),
                                   fault[0]["step"], {1})
        int8_err = _int8_steps(model, cfg, full["params"], data, policy, p_sh, mesh,
                               OptimizerConfig(**job["opt"], quantize_moments=True))
        result[arch] = {"shard_err": shard_err, "placed": placed, "blocks": blocks,
                        "share": float(share), "step": step, "losses": summary["losses"],
                        "restarts": summary["restarts"], "int8_err": int8_err,
                        "fault": fault, "fault_one": fault_one}

    compressed = {}
    for axis, size in zip(("data", "model"), job["mesh"]):
        if size == 1:
            continue
        rng = np.random.default_rng(100 + rank)
        grads = [{"w": torch.as_tensor(rng.normal(size=(16, 32)).astype(np.float32))}
                 for _ in range(3)]
        ef = init_error_feedback(grads[0])
        for i, g in enumerate(grads):
            got, ef = compressed_psum_tree(g, ef, axis_name=axis, mesh=mesh)
            compressed[f"{axis}/out{i}"] = got["w"].numpy()
            compressed[f"{axis}/ef{i}"] = ef["w"].numpy()
    np.savez(out / f"compressed-{rank}.npz", **compressed)
    if rank == 0:
        (out / "result.json").write_text(json.dumps(result))


def _fault_restart(model, data, opt_cfg, ck_dir, shardings, last: int, ranks) -> list:
    """Two steps more from the run's last checkpoint, checkpointing each,
    with a fault injected once at the second on ``ranks`` (None: every
    rank): the trainer restores the first on every rank and runs on.
    Every rank's step, restarts and faults fired."""
    import torch.distributed as dist

    from repro_torch.training import Trainer, TrainerConfig

    fired = []
    rank = dist.get_rank()

    def hook(step):
        if step == last + 2 and not fired and (ranks is None or rank in ranks):
            fired.append(step)
            raise RuntimeError(f"injected fault at step {step} on rank {rank}")

    trainer = Trainer(model, data, opt_cfg=opt_cfg,
                      cfg=TrainerConfig(checkpoint_dir=ck_dir, total_steps=last + 3,
                                        checkpoint_every=1, log_every=1, keep_checkpoints=16),
                      shardings=shardings, fault_hook=hook, device="cpu")
    step, _, _, summary = trainer.train()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"step": step, "restarts": summary["restarts"],
                                   "fired": fired})
    return every


def _int8_steps(model, cfg, tree, data, policy, p_sh, mesh, opt_cfg) -> float:
    """Two steps with int8 moments, sharded (moments on their specs)
    against the same steps unsharded on this rank: the weights' largest
    difference."""
    import torch

    from repro_torch.distributed import fsdp
    from repro_torch.distributed.sharding import named_sharding_tree
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.steps import make_sharded_train_step, make_train_step
    from repro_torch.models.transformer import TransformerParams
    from repro_torch.training.optimizer import init_opt_state, tree_leaves, tree_map

    o_sh = named_sharding_tree(shd.opt_state_pspecs(model, policy, mesh, opt_cfg), mesh)
    plain = TransformerParams(cfg, tree_map(torch.clone, tree))
    plain_opt = init_opt_state(plain.to_tree(), opt_cfg)
    sharded = TransformerParams(cfg, fsdp.shard_tree(tree, p_sh))
    sharded_opt = {**plain_opt, **{k: fsdp.shard_tree(plain_opt[k], o_sh[k])
                                   for k in ("master", "m", "v")}}
    plain_step = make_train_step(model, opt_cfg)
    sharded_step = make_sharded_train_step(model, opt_cfg, (p_sh, o_sh), policy)
    for i in (1, 2):
        batch = {k: torch.as_tensor(v) for k, v in data.batch_at(i).items()}
        plain, plain_opt, _ = plain_step(plain, plain_opt, batch)
        sharded, sharded_opt, _ = sharded_step(sharded, sharded_opt, batch)
    assert all(isinstance(q, fsdp.DTensor) for q in tree_leaves(sharded_opt["m"]))
    return max(float((a.full_tensor() - b).abs().max())
               for a, b in zip(tree_leaves(sharded.to_tree()), tree_leaves(plain.to_tree())))


def _step_fault_rank(rank: int, job: dict, world: int, store_path: str) -> None:
    """The sharded Trainer from the seed (no checkpoint yet) on the job's
    ``step_fault`` arch and steps, checkpointing every step.  On its first
    start rank 1 fails inside its third step, so ``run_ranks`` ends every
    rank and starts them again, and they resume from the last checkpoint.
    Rank 0 writes the steps, losses and restarts of the run that ends."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import LMDataConfig, LMDataset
    from repro_torch.distributed.policies import make_policy
    from repro_torch.distributed.sharding import named_sharding_tree
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, Trainer, TrainerConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        spec = job["step_fault"]
        cfg = get_config(spec["arch"]).reduced()
        model = LM(cfg)
        mesh = make_mesh(tuple(job["mesh"]), ("data", "model"), device="cpu")
        policy = make_policy(cfg, "train", mesh)
        opt_cfg = OptimizerConfig(**job["opt"])
        shardings = (named_sharding_tree(shd.param_pspecs(model, policy, mesh), mesh),
                     named_sharding_tree(shd.opt_state_pspecs(model, policy, mesh, opt_cfg),
                                         mesh))
        trainer = Trainer(model, LMDataset(LMDataConfig(**job["data"],
                                                        vocab_size=cfg.vocab_size)),
                          opt_cfg=opt_cfg,
                          cfg=TrainerConfig(checkpoint_dir=spec["dir"], total_steps=spec["steps"],
                                            checkpoint_every=1, log_every=1),
                          shardings=shardings, device="cpu")
        marker = Path(spec["dir"]) / "fired"
        real, calls = trainer._step, []

        def step(*args):
            calls.append(None)
            if rank == 1 and len(calls) == 3 and not marker.exists():
                marker.touch()
                raise RuntimeError("injected fault inside the step on rank 1")
            return real(*args)

        trainer._step = step
        last, _, _, summary = trainer.train()
        if rank == 0:
            (Path(job["out"]) / "step-fault.json").write_text(json.dumps(
                {"step": last, "losses": summary["losses"], "restarts": summary["restarts"],
                 "fired": marker.exists()}))
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    job = json.loads(Path(argv[1]).read_text())
    sys.path.insert(0, str(ROOT / "src"))
    import torch.multiprocessing as mp

    from repro_torch.launch.train import run_ranks

    if os.path.exists(job["store"]):
        os.unlink(job["store"])
    mp.start_processes(_rank, args=(job,), nprocs=job["world"], start_method="spawn")
    run_ranks(_step_fault_rank, (job,), job["world"], job["out"], restarts=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
