"""Gloo ranks on the CPU for tests/test_torch_dryrun.py: the sharded
serving steps against the unsharded ones.

    python tests/_torch_tp_ranks.py JOB.json

Starts ``world`` processes (spawned) that meet at a ``FileStore`` in the
job's directory and build a ``DeviceMesh`` of the job's (data, model)
shape.  For each reduced arch of the job, every rank draws the same
weights whole and as its shards under the serving policy
(``launch.shardings.serve_shardings``), runs one prefill and the job's
decode steps through ``launch.steps.make_sharded_prefill_step`` and
``make_sharded_decode_step``, and the same through the unsharded steps;
rank 0 writes, per arch, the largest difference of the logits and of
the caches (gathered whole) at every step.  Imports nothing of the JAX
package.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rank(rank: int, job: dict) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(job["store"], job["world"]),
                            rank=rank, world_size=job["world"])
    try:
        _work(rank, job)
    finally:
        dist.destroy_process_group()


def _diff(a, b) -> float:
    from torch.distributed.tensor import DTensor

    a = a.full_tensor() if isinstance(a, DTensor) else a
    return float((a.double() - b.double()).abs().max())


def _work(rank: int, job: dict) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        make_decode_step,
        make_prefill_step,
        make_sharded_decode_step,
        make_sharded_prefill_step,
    )
    from repro_torch.models import LM

    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"), device="cpu")
    b, s, steps = job["batch"], job["seq"], job["steps"]
    max_len = s + steps
    result = {}
    for arch in job["archs"]:
        cfg = get_config(arch).reduced()
        model = LM(cfg)
        p_sh, serve_sh = shd.serve_shardings(model, mesh, b, max_len)
        whole = model.init(seed=3, device="cpu")
        sharded = model.init(seed=3, device="cpu", shardings=p_sh)
        gen = torch.Generator().manual_seed(11)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, dtype=torch.int32)
        logits0, cache0 = make_prefill_step(model, max_len)(whole, tokens)
        logits1, cache1 = make_sharded_prefill_step(model, max_len, serve_sh)(sharded, tokens)
        diffs = {"prefill_logits": _diff(logits1, logits0),
                 "prefill_cache": max(_diff(c1[k], c0[k]) for c0, c1 in
                                      zip(cache0["layers"], cache1["layers"]) for k in c0)}
        dec0, dec1 = make_decode_step(model), make_sharded_decode_step(model, serve_sh)
        tok = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
        for i in range(steps):
            logits0, cache0 = dec0(whole, cache0, tok)
            logits1, cache1 = dec1(sharded, cache1, tok)
            diffs[f"decode{i}_logits"] = _diff(logits1, logits0)
            diffs[f"decode{i}_cache"] = max(_diff(c1[k], c0[k]) for c0, c1 in
                                            zip(cache0["layers"], cache1["layers"]) for k in c0)
            tok = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
        diffs["pos"] = int(cache1["pos"].full_tensor())
        result[arch] = diffs
    if rank == 0:
        Path(job["out"], "tp.json").write_text(json.dumps(result))


def main(argv) -> int:
    import torch.multiprocessing as mp

    sys.path.insert(0, str(ROOT / "src"))
    job = json.loads(Path(argv[1]).read_text())
    mp.start_processes(_rank, args=(job,), nprocs=job["world"], start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
