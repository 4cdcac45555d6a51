"""Serving launcher: the paper's full pipeline on real LM variants, the
counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --policy SneakPeek \\
        --requests 24 --windows 3

Registers an "assistant" application whose variants are three reduced
LM architectures (mamba2 / tinyllama / gemma-7b families), with latency
profiles from the port's dry-run rooflines when `results/dryrun_torch/`
holds them (``python -m repro_torch.launch.dryrun``; otherwise the
analytic fallback, ``serving.profiles`` on one H100), then streams
synthetic classification requests through the port's ``EdgeServer``:
SneakPeek stage -> window queue -> scheduler -> ``LMExecutor`` (real
prefill+decode), on the card unless ``--device cpu``.

The application (``build_application``) and the requests
(``build_requests``) are the reference's: the same recalls and latency
models, and arrivals, deadlines and labels drawn from the seeded
generator in the reference's order.  Where the reference differs: under
``--policy SneakPeek`` each request also carries two-class features,
drawn from a generator of their own (seed + 2) around its own label, and
the application a k-NN SneakPeek model (the SneakPeek stage its
docstring names; the reference attaches none); a variant's weights are
seeded with ``zlib.crc32`` of its name, where the reference's
``hash(name) % 100`` changes from one process to the next; its profiles
come from the port's record directory and serve one card
(``serving.profiles.N_DEVICES``), the reference's load latency a 16-chip
slice's.  The last line counts the kernel launches of the run.
"""
from __future__ import annotations

import argparse
import json
import sys
import zlib

import numpy as np

FEATURE_DIM = 32  # the SneakPeek stage's feature width
KNN_POINTS = 2_000  # its labelled points
SEP = 0.25  # the two classes' centres, -SEP and +SEP in every coordinate
VARIANT_ARCHS = ("mamba2-130m", "tinyllama-1.1b", "gemma-7b")
RECALLS = {
    "mamba2-130m": [0.72, 0.70],
    "tinyllama-1.1b": [0.84, 0.82],
    "gemma-7b": [0.94, 0.92],
}


def _features(rng, labels):
    """Unit-variance Gaussian points around each label's centre."""
    labels = np.asarray(labels)
    centres = np.stack([np.full(FEATURE_DIM, -SEP), np.full(FEATURE_DIM, SEP)])
    return (centres[labels] + rng.normal(size=(len(labels), FEATURE_DIM))).astype(np.float32)


def _two_class(rng, n: int):
    """n points of the two classes and their labels."""
    labels = rng.integers(0, 2, n)
    return _features(rng, labels), labels


def build_application(results_dir=None, n_devices: int | None = None):
    """(the "assistant" ``Application``, its variants {name: (reduced cfg,
    weight seed)}): the reference's profiles, each variant's latency model
    from ``results_dir``'s records or the analytic census over
    ``n_devices`` cards, its load latency its weights over as many cards'
    staging links (one card by default)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import Application, ModelProfile
    from repro_torch.serving.profiles import _DCN_BW, DRYRUN_DIR, N_DEVICES, lm_latency_model

    results_dir = DRYRUN_DIR if results_dir is None else results_dir
    n_devices = N_DEVICES if n_devices is None else n_devices
    profiles, variants = [], {}
    for name in VARIANT_ARCHS:
        fixed, per_item = lm_latency_model(results_dir, name, n_devices=n_devices)
        profiles.append(ModelProfile(
            name=name, recalls=RECALLS[name],
            latency_s=fixed + per_item,
            load_latency_s=2 * ARCHS[name].param_count() / _DCN_BW / n_devices,
            latency_model=(fixed, per_item),
        ))
        variants[name] = (ARCHS[name].reduced(), zlib.crc32(name.encode()) % 100)
    return Application(name="assistant", models=profiles, penalty="sigmoid"), variants


def build_requests(rng, n: int, horizon_s: float, deadline_ms: float, features_seed=None):
    """The reference's ``n`` requests from ``rng`` (per request its arrival,
    deadline and label, in that order); with ``features_seed`` each also
    carries features around its label from a generator of that seed."""
    from repro_torch.core import Request

    reqs = [
        Request(rid=i, app="assistant",
                arrival_s=float(rng.uniform(0, horizon_s)),
                deadline_s=float(rng.uniform(0, horizon_s) + deadline_ms / 1e3),
                true_label=int(rng.integers(2)))
        for i in range(n)
    ]
    if features_seed is not None:
        feats = _features(np.random.default_rng(features_seed), [r.true_label for r in reqs])
        for r, f in zip(reqs, feats):
            r.features = f
    return reqs


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
    from repro_torch.core import make_policy
    from repro_torch.core.sneakpeek import KNNSneakPeek
    from repro_torch.serving import EdgeServer, LMExecutor
    from repro_torch.serving.profiles import DRYRUN_DIR

    rng = np.random.default_rng(args.seed)
    app, variants = build_application(DRYRUN_DIR)
    for m in app.models:
        fixed, per_item = m.latency_model
        print(f"variant {m.name:16s} l(m)={fixed+per_item:8.4f}s "
              f"load={m.load_latency_s:7.3f}s "
              f"({'roofline' if DRYRUN_DIR.exists() else 'analytic'} profile)")

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
    reqs = build_requests(rng, args.requests, horizon, args.deadline_ms,
                          features_seed=args.seed + 2 if sneakpeeks else None)
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
