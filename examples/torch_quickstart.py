"""Quickstart on the PyTorch port: the SneakPeek scheduler in ~60 lines.

The counterpart of ``examples/quickstart.py``.  Registers two
applications with latency/accuracy-tradeoff model variants, streams one
window of requests, and compares a data-oblivious baseline against the
full SneakPeek policy (data-aware grouped scheduling + short-circuit
inference).  On the card the k-NN SneakPeek stage runs K2 (``knn``) and
the Eq. 2 scores of selection and commit run K1 (``utility``);
``--device cpu`` runs their plain versions on the host.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.core import (
    Request,
    evaluate,
    make_policy,
    schedule_window,
)
from repro_torch.data.applications import (
    APP_SPECS,
    make_application,
    make_requests,
    make_sneakpeek,
)
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. Register applications (model variants + per-class recall profiles).
    apps = {
        name: make_application(APP_SPECS[name], penalty="sigmoid")
        for name in ("fall_detection", "heart_monitoring")
    }
    # 2. SneakPeek models: k-NN over each app's training features.
    sneaks = {name: make_sneakpeek(APP_SPECS[name], k=5, device=device) for name in apps}

    # 3. One scheduling window of requests (arrivals over 100 ms, ~150 ms SLOs).
    reqs = make_requests([APP_SPECS[n] for n in apps], per_app=4, seed=0)

    def fresh():
        return [Request(r.rid, r.app, r.arrival_s, r.deadline_s, r.features, r.true_label)
                for r in reqs]

    # 4. Schedule with a deadline-aware baseline and with SneakPeek.
    for name in ("LO-EDF", "SneakPeek"):
        pol = make_policy(name)
        sc = name == "SneakPeek"
        sched, eff_apps = schedule_window(
            pol, fresh(), apps, now=0.1,
            sneakpeeks=sneaks if (pol.data_aware or sc) else None, short_circuit=sc,
            device=device,
        )
        res = evaluate(sched, eff_apps, now=0.1, acc_mode="oracle", device=device)
        print(f"\n{name}:")
        print(f"  mean utility      {res.mean_utility:.3f}")
        print(f"  mean accuracy     {res.accuracies.mean():.3f}")
        print(f"  deadline misses   {res.violations}/{len(res.utilities)}")
        for e in sched.sorted_entries()[:4]:
            print(f"    r{e.request.rid} -> {e.model:28s} start={e.est_start_s*1e3:6.1f}ms "
                  f"deadline={e.request.deadline_s*1e3:6.1f}ms")


if __name__ == "__main__":
    main()
