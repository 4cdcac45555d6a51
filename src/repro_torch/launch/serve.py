"""Serving launcher: the paper's full pipeline on real LM variants, the
counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --policy SneakPeek \\
        --requests 24 --windows 3

Registers an "assistant" application whose variants are three reduced
LM architectures (mamba2 / tinyllama / gemma-7b families), with latency
profiles from the dry-run rooflines when `results/dryrun/` exists
(otherwise the analytic fallback, ``serving.profiles`` on one H100),
then streams synthetic classification requests through the port's
``EdgeServer``: SneakPeek stage -> window queue -> scheduler ->
``LMExecutor`` (real prefill+decode), on the card unless ``--device cpu``.

Where the reference differs: under ``--policy SneakPeek`` each request
carries two-class features and the application a k-NN SneakPeek model
(the SneakPeek stage its docstring names; the reference attaches none),
and a variant's weights are seeded with ``zlib.crc32`` of its name, where
the reference's ``hash(name) % 100`` changes from one process to the
next.  The last line counts the kernel launches of the run.
"""
from __future__ import annotations

import argparse
import json
import sys
import zlib
from pathlib import Path

import numpy as np

FEATURE_DIM = 32  # the SneakPeek stage's feature width
KNN_POINTS = 2_000  # its labelled points


def _two_class(rng, n: int, sep: float = 0.25):
    """n points of two unit-variance Gaussian classes centred at -sep and
    +sep in every coordinate, and their labels."""
    labels = rng.integers(0, 2, n)
    centres = np.stack([np.full(FEATURE_DIM, -sep), np.full(FEATURE_DIM, sep)])
    return (centres[labels] + rng.normal(size=(n, FEATURE_DIM))).astype(np.float32), labels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--policy", default="SneakPeek",
                    choices=["MaxAcc-EDF", "LO-EDF", "LO-Priority", "Grouped", "SneakPeek"])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--deadline-ms", type=float, default=400.0)
    ap.add_argument("--new-tokens", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.core import Application, ModelProfile, Request, make_policy
    from repro_torch.core.sneakpeek import KNNSneakPeek
    from repro_torch.serving import EdgeServer, LMExecutor
    from repro_torch.serving.profiles import _DCN_BW, N_DEVICES, lm_latency_model

    rng = np.random.default_rng(args.seed)
    results_dir = Path(__file__).resolve().parents[3] / "results" / "dryrun"

    variant_archs = ["mamba2-130m", "tinyllama-1.1b", "gemma-7b"]
    recalls = {
        "mamba2-130m": [0.72, 0.70],
        "tinyllama-1.1b": [0.84, 0.82],
        "gemma-7b": [0.94, 0.92],
    }
    profiles, variants = [], {}
    for name in variant_archs:
        fixed, per_item = lm_latency_model(results_dir, name)
        cfg = ARCHS[name].reduced()
        profiles.append(ModelProfile(
            name=name, recalls=recalls[name],
            latency_s=fixed + per_item,
            load_latency_s=2 * ARCHS[name].param_count() / _DCN_BW / N_DEVICES,
            latency_model=(fixed, per_item),
        ))
        variants[name] = (cfg, zlib.crc32(name.encode()) % 100)
        print(f"variant {name:16s} l(m)={fixed+per_item:8.4f}s "
              f"load={profiles[-1].load_latency_s:7.3f}s "
              f"({'roofline' if results_dir.exists() else 'analytic'} profile)")

    app = Application(name="assistant", models=profiles, penalty="sigmoid")
    executor = LMExecutor(variants, new_tokens=args.new_tokens, device=args.device)
    vocab = variants["mamba2-130m"][0].vocab_size
    sneakpeeks = None
    if args.policy == "SneakPeek":
        train_x, train_y = _two_class(np.random.default_rng(args.seed + 1), KNN_POINTS)
        sneakpeeks = {"assistant": KNNSneakPeek(train_x, train_y, 2, seed=args.seed,
                                                device=args.device)}

    def prompt_fn(req):
        return rng.integers(0, vocab, 12).astype(np.int32)

    server = EdgeServer({"assistant": app}, make_policy(args.policy),
                        executor=executor, sneakpeeks=sneakpeeks, prompt_fn=prompt_fn,
                        device=args.device)
    horizon = args.windows * server.queue.window_s
    feats, labels = _two_class(rng, args.requests)
    reqs = [
        Request(rid=i, app="assistant",
                arrival_s=float(rng.uniform(0, horizon)),
                deadline_s=float(rng.uniform(0, horizon) + args.deadline_ms / 1e3),
                true_label=int(labels[i]),
                features=feats[i] if sneakpeeks else None)
        for i in range(args.requests)
    ]
    kernels.reset_launch_counts()
    outs, stats = server.run(reqs, horizon_s=horizon)
    print(f"\npolicy={args.policy} windows={stats.windows} requests={stats.requests}")
    print(f"mean utility {stats.mean_utility:.3f} | violations {stats.violations} | "
          f"swaps {stats.swaps} | sched overhead {stats.scheduling_overhead_s*1e3:.1f} ms")
    for o in outs:
        for rep in o["reports"] or []:
            print(f"  batch[{rep.model:16s}] size={rep.batch_size:2d} "
                  f"prefill={rep.prefill_s*1e3:7.1f}ms decode={rep.decode_s*1e3:7.1f}ms")
    print("kernel launches " + json.dumps(kernels.launch_counts(), sort_keys=True))
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
