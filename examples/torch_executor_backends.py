"""The three executor backends behind one serving interface, on the
PyTorch port.

The counterpart of ``examples/executor_backends.py``.

Section 1 — ``CompiledBackend`` end-to-end: 2 variants x 8 requests
through the full EdgeServer loop with real forward passes: bucketed
shapes, decode replayed from CUDA graphs on the card, per-window
continuous batching, and scheduler profiles minted from the backend's
own realized-latency fit (provenance ``realized``).  By default the
variants are the reduced mamba2-130m and tinyllama-1.1b, as in the
reference; ``--full`` serves the published configs (bf16, random
weights).  On the card prefill runs K5 (``ssd``) and K3
(``flash_attention``), decode K4 (``decode_attention``), and the
scheduler K1 (``utility``); ``--device cpu`` runs the plain versions.

Section 2 — ``CostModelBackend`` profile derivation: the FULL-SIZE
configs (gemma-7b included) get ``ModelProfile``s from the roofline
census, no device execution at all: latency affine in batch, weights +
KV cache footprints, staged swap costs, provenance ``costmodel``.  The
port's census plans each variant on one H100 (``serving.profiles``:
``N_DEVICES = 1``, 25 GB/s staging), not on the reference's 16 TPU
devices, so its numbers are an H100's: mamba2-130m's latency and swap
are larger than the reference prints.

    PYTHONPATH=src python examples/torch_executor_backends.py --full
    PYTHONPATH=src python examples/torch_executor_backends.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.core import Application, Request, make_policy
from repro_torch.device import resolve_device
from repro_torch.serving import CompiledBackend, CostModelBackend, EdgeServer


def compiled_serve(device, full, rng):
    print("=== CompiledBackend: real forwards through EdgeServer ===")
    variants = {
        name: (ARCHS[arch] if full else ARCHS[arch].reduced(), seed)
        for seed, (name, arch) in enumerate((("small", "mamba2-130m"),
                                             ("big", "tinyllama-1.1b")))
    }
    backend = CompiledBackend(variants, new_tokens=2, device=device)
    # Scheduler profiles come from the backend itself: affine latency fit
    # from calibrated forwards, weights+KV footprint, staging swap cost.
    profiles = [
        backend.profile("small", recalls=[0.75, 0.72]),
        backend.profile("big", recalls=[0.92, 0.90]),
    ]
    for p in profiles:
        print(f"  {p.name}: provenance={p.provenance} "
              f"latency={p.latency_s * 1e3:.2f}ms mem={p.memory_bytes / 1e6:.2f}MB")
    app = Application(name="assistant", models=profiles, penalty="sigmoid")
    # Tokens below the smaller vocabulary, valid for both variants (the
    # reduced configs share one of 128).
    vocab = min(cfg.vocab_size for cfg, _ in variants.values())

    def prompt_fn(req):
        return np.random.default_rng(req.rid).integers(0, vocab, 12).astype(np.int32)

    server = EdgeServer(
        {"assistant": app}, make_policy("SneakPeek"),
        backend=backend, prompt_fn=prompt_fn, device=device,
    )
    reqs = [
        Request(rid=i, app="assistant", arrival_s=0.01 * (i + 1),
                deadline_s=0.01 * i + float(rng.choice([0.3, 0.6, 1.0])),
                true_label=int(rng.integers(2)), theta=np.full(2, 0.5))
        for i in range(8)
    ]
    with server:
        outs, stats = server.run(reqs)
    reports = [r for o in outs for r in o["reports"]]
    served = sum(r.batch_size for r in reports)
    assert served == len(reqs), (served, len(reqs))
    assert all(r.tokens.shape[1] == 2 for r in reports), "no generated tokens?"
    assert stats.profile_provenance == {"small": "realized", "big": "realized"}
    print(f"  served {served} requests in {stats.windows} windows, "
          f"swaps={stats.swaps}, mean_utility={stats.mean_utility:.3f}")
    print(f"  provenance: {stats.profile_provenance}")


def costmodel_profiles():
    print("=== CostModelBackend: profiles with no device execution ===")
    backend = CostModelBackend(
        {"mamba2-130m": "mamba2-130m",
         "tinyllama-1.1b": "tinyllama-1.1b",
         "gemma-7b": "gemma-7b"},
        prompt_tokens=512, new_tokens=64,
    )
    profs = backend.profiles({
        "mamba2-130m": [0.72, 0.70],
        "tinyllama-1.1b": [0.84, 0.82],
        "gemma-7b": [0.94, 0.92],
    })
    lat = {}
    for name, p in profs.items():
        assert p.provenance == "costmodel"
        lat[name] = p.latency_s
        print(f"  {name}: latency(b=1)={p.latency_s * 1e3:.2f}ms "
              f"swap={p.load_latency_s * 1e3:.1f}ms "
              f"mem(w+kv)={backend.model_bytes(name) / 1e9:.2f}GB")
    # The census must preserve the size ordering the scheduler trades on.
    assert lat["mamba2-130m"] < lat["tinyllama-1.1b"] < lat["gemma-7b"]
    print("  latency ordering small < mid < large holds")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="serve the published configs (bf16, random weights)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compiled_serve(device, args.full, np.random.default_rng(7))
    print()
    costmodel_profiles()
    print("\nOK")


if __name__ == "__main__":
    main()
