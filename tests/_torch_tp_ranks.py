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
the caches (gathered whole) at every step.  An arch may name a variant
after a slash (``VARIANTS``: a routed MoE whose capacity drops tokens);
a MoE variant's layers' routes are recorded in both runs, and each rank counts
the tokens whose expert or kept flag differs between its groups' routes
and the same groups' unsharded ones.  Imports nothing of the JAX
package.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Config overrides of "arch/variant": MoE capacities that drop tokens,
# top-1 and top-2; SSD with two groups of B and C.
VARIANTS = {"drops": {"capacity_factor": 1.0},
            "drops-top2": {"moe_top_k": 2, "capacity_factor": 0.5},
            "g2": {"ssd_ngroups": 2}}


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


def dist_sum(n: int) -> int:
    """``n`` summed over the ranks."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([n], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t)


def _diff(a, b) -> float:
    from torch.distributed.tensor import DTensor

    a = a.full_tensor() if isinstance(a, DTensor) else a
    return float((a.double() - b.double()).abs().max())


class _Routes:
    """Records each ``moe._routes`` call's (expert, kept) per round."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls, self.orig = moe, [], moe._routes

    def __enter__(self):
        def routes(probs, top_k, cap):
            out = self.orig(probs, top_k, cap)
            self.calls.append([(e.clone(), k.clone()) for e, _, k, _ in out])
            return out

        self.moe._routes = routes
        return self

    def __exit__(self, *exc):
        self.moe._routes = self.orig


def _route_mismatches(whole, sharded, mesh) -> tuple[int, int]:
    """(tokens routed differently, tokens dropped): each sharded call's
    groups against the same groups of the unsharded call."""
    bad = dropped = 0
    for w, s in zip(whole, sharded, strict=True):
        for (ew, kw), (es, ks) in zip(w, s, strict=True):
            ng, rows = ew.shape[0], es.shape[0]
            first = 0
            if rows < ng:  # this rank's groups: whole groups over the data axis
                first = mesh.get_local_rank("data") * rows
            ew, kw = ew[first:first + rows], kw[first:first + rows]
            bad += int(((ew != es) | (kw != ks)).sum())
            dropped += int((~kw).sum())
    return bad, dropped


def _work(rank: int, job: dict) -> None:
    import dataclasses

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
        name, _, variant = arch.partition("/")
        cfg = dataclasses.replace(get_config(name).reduced(), **VARIANTS.get(variant, {}))
        model = LM(cfg)
        p_sh, serve_sh = shd.serve_shardings(model, mesh, b, max_len)
        whole = model.init(seed=3, device="cpu")
        sharded = model.init(seed=3, device="cpu", shardings=p_sh)
        gen = torch.Generator().manual_seed(11)
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, dtype=torch.int32)
        with _Routes() as r0:
            logits0, cache0 = make_prefill_step(model, max_len)(whole, tokens)
        with _Routes() as r1:
            logits1, cache1 = make_sharded_prefill_step(model, max_len, serve_sh)(sharded, tokens)
        diffs = {"prefill_logits": _diff(logits1, logits0),
                 "prefill_cache": max(_diff(c1[k], c0[k]) for c0, c1 in
                                      zip(cache0["layers"], cache1["layers"]) for k in c0)}
        dec0, dec1 = make_decode_step(model), make_sharded_decode_step(model, serve_sh)
        tok = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
        for i in range(steps):
            with r0:
                logits0, cache0 = dec0(whole, cache0, tok)
            with r1:
                logits1, cache1 = dec1(sharded, cache1, tok)
            diffs[f"decode{i}_logits"] = _diff(logits1, logits0)
            diffs[f"decode{i}_cache"] = max(_diff(c1[k], c0[k]) for c0, c1 in
                                            zip(cache0["layers"], cache1["layers"]) for k in c0)
            tok = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
        diffs["pos"] = int(cache1["pos"].full_tensor())
        if variant.startswith("drops"):
            bad, dropped = _route_mismatches(r0.calls, r1.calls, mesh)
            diffs["routes"] = int(dist_sum(bad))
            diffs["dropped"] = dropped
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
