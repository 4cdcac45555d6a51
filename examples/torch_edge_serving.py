"""End-to-end LM serving with SneakPeek scheduling on the PyTorch port.

The counterpart of ``examples/edge_serving.py``.  One "assistant"
application registers three LM variants spanning the latency/accuracy
trade-off (mamba2 / tinyllama / gemma-7b families).  A stream of
classification-style requests flows through:

    SneakPeek stage -> window queue -> grouped scheduler -> LMExecutor

with the executor actually running prefill+decode per scheduled batch
and the swap manager accounting weight-residency.  By default the
variants are the reduced configs, as in the reference; ``--full`` serves
the published mamba2-130m, tinyllama-1.1b and gemma-7b (bf16, random
weights; gemma-7b alone is 17.1 GB).  On the card the scheduling
equations run K1 (``utility``), prefill runs K5 (``ssd``, mamba2) and K3
(``flash_attention``), and decode K4 (``decode_attention``) from CUDA
graphs.  ``--device cpu`` runs the plain versions on the host.

A second section runs the same application on a heterogeneous 2-worker
pool: Eq. 15 placement splits each window across workers and the
``ExecutorPool`` execution plane runs each worker's share on its own
lane (own swap manager, speed-scaled accounting), feeding per-worker
swap counts and busy time into ``ServeStats``.  A third section closes
the loop: a seeded crash and health tracking.

    PYTHONPATH=src python examples/torch_edge_serving.py
    PYTHONPATH=src python examples/torch_edge_serving.py --full
    PYTHONPATH=src python examples/torch_edge_serving.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.core import Application, ModelProfile, Request, Worker, make_policy
from repro_torch.device import resolve_device
from repro_torch.serving import EdgeServer, FaultPlan, FaultSpec, LMExecutor

FAMILIES = ("mamba2-130m", "tinyllama-1.1b", "gemma-7b")


def main(argv=None):
    """Returns the models each section's batches ran and the closed loop's
    submitted and recorded request ids and failure counts, which its
    realized latencies decide."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="serve the published configs (bf16, random weights)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)

    variants = {
        name: (ARCHS[name] if args.full else ARCHS[name].reduced(), seed)
        for seed, name in enumerate(FAMILIES)
    }
    # Profiles: latency spans ~8x; per-class recall improves with size.
    profiles = [
        ModelProfile("mamba2-130m", recalls=[0.72, 0.70], latency_s=0.010, load_latency_s=0.02),
        ModelProfile("tinyllama-1.1b", recalls=[0.84, 0.82], latency_s=0.030, load_latency_s=0.06),
        ModelProfile("gemma-7b", recalls=[0.94, 0.92], latency_s=0.080, load_latency_s=0.18),
    ]
    app = Application(name="assistant", models=profiles, penalty="sigmoid")
    executor = LMExecutor(variants, new_tokens=3, device=device)
    # The later sections' executors read this one's weights (spawn): one
    # copy on the card, drawn from the same seeds as the reference's
    # fresh executors, so the same values.
    weights = executor.backend

    # Tokens below the smallest vocabulary, so that every prompt is valid
    # for each family (the reduced configs share one of 128).
    vocab = min(cfg.vocab_size for cfg, _ in variants.values())

    def prompt_fn(req):
        # Seeded per request: the executor-pool lanes call this from
        # multiple threads, so no shared generator state is mutated.
        return np.random.default_rng(req.rid).integers(0, vocab, 12).astype(np.int32)

    ran = {}
    reqs = [
        Request(rid=i, app="assistant", arrival_s=0.01 * i,
                deadline_s=0.01 * i + rng.choice([0.08, 0.2, 0.5]), true_label=int(rng.integers(2)))
        for i in range(12)
    ]
    # Context manager: releases the pool's lanes (and any process-lane
    # workers) on exit.
    with EdgeServer(
        {"assistant": app}, make_policy("Grouped"), executor=executor, prompt_fn=prompt_fn,
        device=device,
    ) as server:
        outs, stats = server.run(reqs)

    print("windows:", stats.windows, " requests:", stats.requests)
    print(f"mean utility {stats.mean_utility:.3f}  violations {stats.violations}  "
          f"weight swaps {stats.swaps}")
    print(f"host scheduling wall {stats.sched_wall_s*1e3:.1f}ms  "
          f"lane execution wall {stats.exec_wall_s*1e3:.1f}ms")
    for o in outs:
        for rep in o["reports"] or []:
            print(f"  batch[{rep.model:16s}] size={rep.batch_size} "
                  f"swap={rep.swap_s*1e3:6.1f}ms prefill={rep.prefill_s*1e3:6.1f}ms "
                  f"decode={rep.decode_s*1e3:6.1f}ms tokens={rep.tokens.shape}")
    ran["grouped"] = _models_ran(outs)

    print("\nmulti-worker pool: Eq. 15 placement + per-worker execution lanes")
    reqs = [
        Request(rid=100 + i, app="assistant", arrival_s=0.01 * i,
                deadline_s=0.01 * i + rng.choice([0.08, 0.2, 0.5]),
                true_label=int(rng.integers(2)))
        for i in range(12)
    ]
    with EdgeServer(
        {"assistant": app}, make_policy("LO-EDF"),
        executor=LMExecutor(backend=weights.spawn()), prompt_fn=prompt_fn,
        workers=[Worker(0), Worker(1, speed=2.0)], device=device,
    ) as pool_srv:
        outs, stats = pool_srv.run(reqs)
        print(f"windows: {stats.windows}  requests: {stats.requests}  "
              f"mean utility {stats.mean_utility:.3f}")
        print(f"host scheduling wall {stats.sched_wall_s*1e3:.1f}ms  "
              f"lane execution wall {stats.exec_wall_s*1e3:.1f}ms")
        for w in sorted(stats.worker_swaps):
            print(f"  worker {w}: swaps={stats.worker_swaps[w]} "
                  f"busy={stats.pool_busy_s[w]*1e3:7.1f}ms "
                  f"(speed x{pool_srv.pool.lanes[w].worker.speed:g})")
    placed = {}
    for o in outs:
        for e in o["schedule"].entries:
            placed[e.worker] = placed.get(e.worker, 0) + 1
    print(f"  placement: {dict(sorted(placed.items()))} requests per worker")
    ran["pool"] = _models_ran(outs)

    print("\nfault-tolerant closed loop: seeded crash + health tracking")
    # window=None, batch=None: crash worker 0's FIRST dispatched batch,
    # whichever window this policy's placement gives it work in.
    plan = FaultPlan(specs=(FaultSpec(kind="crash", worker=0, window=None,
                                      batch=None),),
                     seed=0)
    reqs = [
        Request(rid=200 + i, app="assistant", arrival_s=0.01 * i,
                deadline_s=0.01 * i + 1.0, true_label=int(rng.integers(2)))
        for i in range(12)
    ]
    with EdgeServer(
        {"assistant": app}, make_policy("LO-EDF"),
        executor=LMExecutor(backend=weights.spawn()), prompt_fn=prompt_fn,
        workers=[Worker(0), Worker(1, speed=2.0)],
        faults=plan, health=True, device=device,
    ) as ft_srv:
        outs, fstats = ft_srv.run(reqs)
        recorded = sorted(ft_srv._records)
    print(f"windows: {fstats.windows}  requests: {fstats.requests}  "
          f"mean utility {fstats.mean_utility:.3f}")
    print(f"  failed batches={fstats.failed_batches} retries={fstats.retries} "
          f"dropped={fstats.dropped_after_retry} fallbacks={fstats.fallbacks} "
          f"quarantined={fstats.quarantined_workers}")
    ratios = " ".join(f"w{w}={r:.2f}"
                      for w, r in sorted(fstats.realized_over_profiled.items()))
    print(f"  realized/profiled EWMA: {ratios}")
    # Which estimate is the EWMA correcting?  The profile provenance
    # (profiled / costmodel / realized) names the baseline per model.
    prov = " ".join(f"{m}={p}"
                    for m, p in sorted(fstats.profile_provenance.items()))
    print(f"  profile provenance: {prov}")
    ran["closed_loop"] = _models_ran(outs)
    return {"models_ran": ran,
            "closed_loop": {"submitted": [r.rid for r in reqs], "recorded": recorded,
                            "failed_batches": fstats.failed_batches,
                            "retries": fstats.retries}}


def _models_ran(outs):
    """The models whose batches ran, and the requests each served."""
    served = {}
    for o in outs:
        for rep in o["reports"] or []:
            served[rep.model] = served.get(rep.model, 0) + rep.batch_size
    return dict(sorted(served.items()))


if __name__ == "__main__":
    main()
