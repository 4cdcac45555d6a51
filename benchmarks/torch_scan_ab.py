"""Device times of the window scans of two or more checkouts of the port, in
one run on one NVIDIA GPU.

    python3 benchmarks/torch_scan_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a checkout holding ``src/repro_torch`` (for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The roots run one after the other, each in a
process of its own that builds its kernels into its own ``build/kernels``
and times, with CUDA events, the sequential ``selection_scan`` and, where
the checkout has it, the chunked ``spec_scan`` at chunks 1, 16 and 64, on
the same seeded tables at the compiled window's shapes: the per-request
scan (S = 4,095 steps, one member, M = 6) on one worker and on four, the
grouped scan (17 groups of up to 1,232 members) and the same on four
workers; each with the single-slot and the LRU carry.  Then the sharded
rounds: ``shard_round``'s ``chain`` over 4,094 positions (the longest
chain of phase 15 (a)'s LO-EDF window) with each carry, and LO-EDF's
window of 4,095 requests through ``ShardedWindowPipeline`` on four shard
blocks of the one card at ``chunk=16`` and ``chunk=0``, its scheduling
seconds (host clock, the card synchronised) and ``shard_round`` launches.
A device time is the median of ``--iters`` launches, each between its own
pair of events, after three warm-up launches; a window's seconds the
median of ``--iters`` windows after one.  Give the roots in turns (A, B,
B, A), so a
drift of the card over the run shows as a difference between the two
times of one root.  Prints one line per (root, case) and a JSON line per
root.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

# (steps, members, models, workers, applications) of each shape.
SHAPES = {
    "per-request": (4095, 1, 6, 1, 3),
    "per-request on four workers": (4095, 1, 6, 4, 3),
    "grouped": (17, 1232, 6, 1, 17),
    "four workers": (17, 1232, 6, 4, 17),
}
CHUNKS = (1, 16, 64)
CHAIN_POSITIONS = 4094
SHARD_BLOCKS = 4
WINDOW_PER_APP = 1365  # three applications: a window of 4,095 requests


def tables(shape, res_mode, seed=0):
    """Seeded step and application tables of one scan (as the card tests
    draw them): quantized accuracies and latencies so ties happen, member
    counts up to the shape's, integer byte sizes under an evicting
    capacity."""
    import numpy as np
    import torch

    rng = np.random.default_rng([seed, len(shape), len(res_mode)])
    s, b, m, w, a = SHAPES[shape]
    n_ids = a * m
    gid = np.full((a, m), -2, dtype=np.int64)
    valid = np.zeros((a, m), dtype=bool)
    for i in range(a):
        mi = int(rng.integers(1, m + 1))
        gid[i, :mi] = rng.permutation(n_ids)[:mi]
        valid[i, :mi] = True
    counts = rng.integers(1, b + 1, s)
    mask = (np.arange(b)[None, :] < counts[:, None]).astype(np.float64)
    res0 = np.full((w, n_ids), -1, dtype=np.int64)
    for wi in range(w):
        held = rng.permutation(n_ids)[: (1 if res_mode == "slot1" else 4)]
        res0[wi, : len(held)] = held
    if res_mode == "slot1":
        res0 = res0[:, :1].copy()
    tabs = {
        "acc": np.round(rng.uniform(0.5, 1.0, (s, b, m)) * 16) / 16,
        "mask": mask,
        "deadlines": np.where(mask > 0, rng.uniform(0.05, 3.0, (s, b)), 1.0),
        "bsize": counts.astype(np.float64),
        "lat": np.round(rng.uniform(0.001, 0.01, (s, w, m)) * 1024) / 1024,
        "step_app": rng.integers(0, a, s),
        "swap": np.round(rng.uniform(0.0, 0.05, (a, w, m)) * 1024) / 1024,
        "gid": gid,
        "valid": valid,
        "pen": rng.integers(0, 4, a),
        "pref": np.stack([rng.permutation(w * m) for _ in range(a)]),
    }
    cuda = torch.device("cuda")
    tabs = {k: torch.as_tensor(v, device=cuda) for k, v in tabs.items()}
    sizes = np.tile(rng.integers(1, 600, n_ids).astype(np.float64) * 2**20, (w, 1))
    t0 = np.round(rng.uniform(0.1, 0.3, w) * 1024) / 1024
    return (t0, res0, sizes, 900.0 * 2**20), tabs


def time_one(root: Path, iters: int) -> dict:
    """Times of one checkout's scans, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels.selection_scan import ops as scan_ops

    try:
        from repro_torch.kernels.spec_scan import ops as spec_ops
    except ImportError:  # a checkout from before the chunked scan
        spec_ops = None

    def median_ms(call):
        for _ in range(3):
            call()
        times = []
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    out = {}
    for shape in SHAPES:
        for res_mode in ("slot1", "lru"):
            seed, t = tables(shape, res_mode)
            args = (*seed, res_mode, t["acc"], t["mask"], t["deadlines"],
                    t["bsize"], t["lat"], t["step_app"], t["swap"], t["gid"], t["valid"],
                    t["pen"], t["pref"])
            seq = scan_ops.selection_scan(*args)
            row = {"sequential": median_ms(lambda: scan_ops.selection_scan(*args))}
            if spec_ops is not None:
                for chunk in CHUNKS:
                    got = spec_ops.spec_scan(*args, chunk=chunk)
                    if not torch.equal(got[:, :-1], seq):
                        raise SystemExit(f"{root}: spec_scan at chunk {chunk} differs from "
                                         f"selection_scan ({shape}, {res_mode})")
                    row[f"chunk {chunk}"] = median_ms(
                        lambda: spec_ops.spec_scan(*args, chunk=chunk))
            out[f"{shape}, {res_mode}"] = row
    out.update(time_sharded(iters, median_ms))
    return out


def time_sharded(iters: int, median_ms) -> dict:
    """The sharded rounds of one checkout: the chain's device time, and
    LO-EDF's window on SHARD_BLOCKS blocks of the card."""
    import time

    import numpy as np
    import torch

    from repro_torch.core import shard as tshard
    from repro_torch.core.scheduler import make_policy
    from repro_torch.data import applications as apps_mod
    from repro_torch.kernels.shard_round import ops as shard_ops

    out = {}
    rng = np.random.default_rng(7)
    cuda = torch.device("cuda")
    n, n_ids = CHAIN_POSITIONS, 18
    for res_mode in ("slot1", "lru"):
        k = 1 if res_mode == "slot1" else n_ids
        res0 = np.full((1, k), -1, dtype=np.int64)
        res0[0, : min(k, 4)] = rng.permutation(n_ids)[: min(k, 4)]
        args = (torch.tensor([0.25], device=cuda, dtype=torch.float64),
                torch.as_tensor(res0, device=cuda),
                torch.as_tensor(rng.integers(1, 600, (1, n_ids)) * 2.0**20, device=cuda),
                900.0 * 2**20, res_mode == "slot1",
                torch.zeros(n, dtype=torch.int64, device=cuda),
                torch.as_tensor(rng.integers(0, n_ids, n), device=cuda),
                torch.as_tensor(np.round(rng.uniform(0.0, 0.05, n) * 1024) / 1024, device=cuda),
                torch.as_tensor(np.round(rng.uniform(0.001, 0.01, n) * 1024) / 1024,
                                device=cuda))
        # Five chains back to back between the events: the host's time to
        # enqueue one (~0.05 ms) hides behind the one before.
        out[f"chain {n}, {res_mode}"] = {
            "ms": median_ms(lambda: [shard_ops.chain(*args) for _ in range(5)]) / 5}
    apps, _ = apps_mod.build_benchmark_suite(seed=0, device=cuda)
    reqs = apps_mod.make_requests(list(apps_mod.APP_SPECS.values()), per_app=WINDOW_PER_APP,
                                  deadline_std_s=0.05, seed=0)
    prev = tshard.force_shard_devices(SHARD_BLOCKS)
    try:
        for chunk in (16, 0):
            pipe = tshard.ShardedWindowPipeline(apps, policy=make_policy("LO-EDF", pipeline=True),
                                                chunk=chunk, shard=SHARD_BLOCKS, device=cuda)
            seconds = []
            for i in range(iters + 1):
                torch.cuda.synchronize()
                before = shard_ops.counter.count
                t0 = time.perf_counter()
                pipe.schedule(reqs, 0.1)
                torch.cuda.synchronize()
                if i:
                    seconds.append(time.perf_counter() - t0)
                launches = shard_ops.counter.count - before
            out[f"LO-EDF window, {SHARD_BLOCKS} blocks, chunk {chunk}"] = {
                "s": statistics.median(seconds), "shard_round launches": launches,
                "rounds": pipe.last_shard_stats["rounds"]}
    finally:
        tshard.force_shard_devices(prev)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="*", type=Path)
    parser.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)
    if args.one is not None:
        print(json.dumps(time_one(args.one.resolve(), args.iters)))
        return 0
    if not args.roots:
        parser.error("give at least one checkout")
    for k, root in enumerate(args.roots):
        proc = subprocess.run([sys.executable, __file__, "--one", str(root),
                               "--iters", str(args.iters)], capture_output=True, text=True)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for case, row in times.items():
            print(f"[{k}] {root}: {case}: " + ", ".join(
                f"{n} {v:.6f} ms" if n not in ("s", "shard_round launches", "rounds") else
                (f"{v:.6f} s" if n == "s" else f"{n} {v}") for n, v in row.items()))
        print(json.dumps({"run": k, "root": str(root), "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
