"""The port's scheduling window (repro_torch) against the JAX package's.

The same windows, made from the same seeds, go through the JAX package's
SneakPeek stage and policies and through the port's on the CPU
(``device="cpu"``): evidence, posteriors, the full decision tuples of all
five policies, the evaluated utilities and a multi-window Simulation must
agree.  Also checked: the port regenerates the JAX package's synthetic
data byte for byte, the state conversions round-trip, and no file of the
port imports JAX or the JAX package.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import POLICY_NAMES
from repro.core import Simulation as JSimulation
from repro.core import effective_apps as j_effective_apps
from repro.core import evaluate as j_evaluate
from repro.core import make_policy as j_make_policy
from repro.core.sneakpeek import KNNSneakPeek as JKNNSneakPeek
from repro.core.sneakpeek import attach_sneakpeek as j_attach
from repro.core.sneakpeek import ingest_window as j_ingest
from repro.data import applications as japps
from repro_torch import convert
from repro_torch.core import scheduler as tsched
from repro_torch.core.evaluation import evaluate as t_evaluate
from repro_torch.core.simulator import Simulation as TSimulation
from repro_torch.core.simulator import run_window as t_run_window
from repro_torch.core.sneakpeek import attach_sneakpeek as t_attach
from repro_torch.core.sneakpeek import ingest_window as t_ingest
from repro_torch.data import applications as tapps

REPO = Path(__file__).resolve().parent.parent
PER_APP = {12: 4, 60: 20, 300: 100}  # window size -> requests per application
THETA_MODES = ["all", "some", "none"]


def _sig(sched):
    return [
        (e.request.rid, e.model, e.order, e.batch_id, e.est_start_s, e.est_latency_s)
        for e in sched.sorted_entries()
    ]


@pytest.fixture(scope="module")
def suites():
    """(JAX apps, JAX numpy-backed sneakpeeks, port apps, port sneakpeeks)."""
    j_apps, j_sneaks = japps.build_benchmark_suite(backend="numpy", seed=0)
    t_apps, t_sneaks = tapps.build_benchmark_suite(seed=0, device="cpu")
    return j_apps, j_sneaks, t_apps, t_sneaks


def _window(mod, apps, sneaks, per_app, seed, theta, attach):
    """One randomized window, as tests/test_pipeline.py builds it;
    ``theta`` = "all" | "some" | "none"."""
    reqs = mod.make_requests(
        list(mod.APP_SPECS.values()), per_app=per_app, deadline_std_s=0.05, seed=seed
    )
    if theta != "none":
        attach(reqs, apps, sneaks)
        if theta == "some":
            for r in reqs[::3]:
                r.theta = None
                r.evidence = None
    return reqs


@pytest.fixture(scope="module")
def windows(suites):
    """Every (size, theta) window, built once for both packages."""
    j_apps, j_sneaks, t_apps, t_sneaks = suites
    out = {}
    for size, per_app in PER_APP.items():
        for seed, theta in enumerate(THETA_MODES):
            j = _window(japps, j_apps, j_sneaks, per_app, seed, theta, j_attach)
            t = _window(tapps, t_apps, t_sneaks, per_app, seed, theta,
                        lambda r, a, s: t_attach(r, a, s, device="cpu"))
            out[size, theta] = (j, t)
    return out


@pytest.mark.parametrize("size", list(PER_APP))
@pytest.mark.parametrize("theta", THETA_MODES)
@pytest.mark.parametrize("short_circuit", [False, True], ids=["plain", "short_circuit"])
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_schedule_window_matches_reference(suites, windows, policy, short_circuit, theta, size):
    """Decision tuples equal to the JAX package's; utilities within 1e-12."""
    j_apps, j_sneaks, t_apps, t_sneaks = suites
    j_reqs, t_reqs = windows[size, theta]
    j_eff = j_effective_apps(j_apps, j_sneaks, short_circuit)
    t_eff = tsched.effective_apps(t_apps, t_sneaks, short_circuit)
    j_sched = j_make_policy(policy).schedule(j_reqs, j_eff, 0.1)
    t_sched = tsched.make_policy(policy).schedule(t_reqs, t_eff, 0.1, device="cpu")
    assert _sig(t_sched) == _sig(j_sched)
    jr = j_evaluate(j_sched, j_eff, 0.1, acc_mode="oracle")
    tr = t_evaluate(t_sched, t_eff, 0.1, acc_mode="oracle", device="cpu")
    np.testing.assert_allclose(tr.utilities, jr.utilities, atol=1e-12, rtol=0)
    np.testing.assert_allclose(tr.completions, jr.completions, atol=1e-12, rtol=0)
    assert tr.violations == jr.violations


@pytest.mark.parametrize("policy", ["LO-EDF", "SneakPeek"])
def test_scalar_host_path_matches_fast_path(suites, windows, policy):
    """``fastpath=False`` (scalar host loops) gives the fast path's decisions."""
    _, _, t_apps, t_sneaks = suites
    _, t_reqs = windows[60, "some"]
    eff = tsched.effective_apps(t_apps, t_sneaks, True)
    fast = tsched.make_policy(policy).schedule(t_reqs, eff, 0.1, device="cpu")
    slow = tsched.make_policy(policy, fastpath=False).schedule(t_reqs, eff, 0.1, device="cpu")
    assert _sig(fast) == _sig(slow)


def test_ingest_matches_pallas_knn(suites):
    """Evidence identical and theta bit-identical to the JAX package's
    ``ingest_window`` with its k-NN on the Pallas kernel (interpret mode)."""
    j_apps, j_sneaks, t_apps, t_sneaks = suites
    jax_sneaks = {
        name: JKNNSneakPeek(sp.train_x, sp.train_y, sp.num_classes, k=sp.k,
                            backend="jax")
        for name, sp in j_sneaks.items()
    }
    for name, sp in jax_sneaks.items():
        # The constructor splits again; search the suite's training split.
        sp.train_x, sp.train_y = j_sneaks[name].train_x, j_sneaks[name].train_y
    j_reqs = japps.make_requests(list(japps.APP_SPECS.values()), per_app=16, seed=5)
    t_reqs = tapps.make_requests(list(tapps.APP_SPECS.values()), per_app=16, seed=5)
    j_ingest(j_reqs, j_apps, jax_sneaks)
    t_ingest(t_reqs, t_apps, t_sneaks, device="cpu")
    for j, t in zip(j_reqs, t_reqs):
        np.testing.assert_array_equal(t.evidence, j.evidence)
        np.testing.assert_array_equal(t.theta, j.theta)


def test_measured_recalls_match(suites):
    """The short-circuit profiles (held-out k-NN recalls) are identical."""
    _, j_sneaks, _, t_sneaks = suites
    for name in j_sneaks:
        np.testing.assert_array_equal(
            t_sneaks[name].measured_recalls(), j_sneaks[name].measured_recalls()
        )


@pytest.mark.parametrize("policy", ["SneakPeek", "LO-Priority"])
def test_simulation_matches_reference(policy):
    """Three streamed windows with carried backlog and residency: the same
    aggregate metrics and per-window log."""
    j_apps, j_sneaks = japps.build_benchmark_suite(backend="numpy", seed=1)
    t_apps, t_sneaks = tapps.build_benchmark_suite(seed=1, device="cpu")

    def trace(mod):
        out = []
        for w in range(3):
            reqs = mod.make_requests(list(mod.APP_SPECS.values()), per_app=10,
                                     deadline_std_s=0.05, seed=20 + w, start_rid=30 * w)
            for r in reqs:
                r.arrival_s += 0.1 * w
                r.deadline_s += 0.1 * w
            out.extend(reqs)
        return out

    j_sim = JSimulation(j_make_policy(policy), j_apps, sneakpeeks=j_sneaks,
                        short_circuit=True, seed=3)
    t_sim = TSimulation(tsched.make_policy(policy), t_apps, sneakpeeks=t_sneaks,
                        short_circuit=True, seed=3, device="cpu")
    j_out = j_sim.run(trace(japps))
    t_out = t_sim.run(trace(tapps))
    assert t_out.keys() == j_out.keys()
    for key in ("count", "violations", "accuracy", "violation_rate"):
        assert t_out[key] == j_out[key], key
    assert t_out["utility"] == pytest.approx(j_out["utility"], abs=1e-12)
    assert len(t_sim.log) == len(j_sim.log) == 3
    for t_row, j_row in zip(t_sim.log, j_sim.log):
        for key in ("window", "n", "violations"):
            assert t_row[key] == j_row[key]
        for key in ("utility", "backlog_s", "utilization"):
            assert t_row[key] == pytest.approx(j_row[key], abs=1e-12)
    assert t_sim.state.resident_models() == {
        w: list(tl._resident) for w, tl in j_sim.state.items()
    }


def test_run_window_matches_reference(suites):
    j_apps, j_sneaks, t_apps, t_sneaks = suites
    from repro.core import run_window as j_run_window

    j_reqs = japps.make_requests(list(japps.APP_SPECS.values()), per_app=8, seed=9)
    t_reqs = tapps.make_requests(list(tapps.APP_SPECS.values()), per_app=8, seed=9)
    jr = j_run_window(j_make_policy("SneakPeek"), j_reqs, j_apps, 0.1,
                      sneakpeeks=j_sneaks, short_circuit=True)
    tr = t_run_window(tsched.make_policy("SneakPeek"), t_reqs, t_apps, 0.1,
                      sneakpeeks=t_sneaks, short_circuit=True, device="cpu")
    assert _sig(tr.schedule) == _sig(jr.schedule)
    assert tr.mean_utility == pytest.approx(jr.mean_utility, abs=1e-12)


# --------------------------------------------------------------- state


def test_data_regenerates_byte_identical():
    """Same generators, same seeds: byte-identical arrays."""
    for name, spec in japps.APP_SPECS.items():
        tspec = tapps.APP_SPECS[name]
        jx, jy = japps.make_dataset(spec, 257, np.random.default_rng(4))
        tx, ty = tapps.make_dataset(tspec, 257, np.random.default_rng(4))
        assert jx.tobytes() == tx.tobytes() and jy.tobytes() == ty.tobytes()
        for prior in ("uninformative", "weak", "strong"):
            ja = japps.make_application(spec, prior=prior, seed=2)
            ta = tapps.make_application(tspec, prior=prior, seed=2)
            ja_arr = convert.application_to_arrays(ja)
            ta_arr = convert.application_to_arrays(ta)
            for key, value in ja_arr.items():
                if isinstance(value, np.ndarray):
                    assert value.tobytes() == ta_arr[key].tobytes(), key
                else:
                    assert value == ta_arr[key], key
        jsp = japps.make_sneakpeek(spec, train_n=300, seed=1, backend="numpy")
        tsp = tapps.make_sneakpeek(tspec, train_n=300, seed=1, device="cpu")
        jk, tk = convert.knn_sneakpeek_to_arrays(jsp), convert.knn_sneakpeek_to_arrays(tsp)
        for key, value in jk.items():
            assert np.asarray(value).tobytes() == np.asarray(tk[key]).tobytes(), key
    jr = japps.make_requests(list(japps.APP_SPECS.values()), per_app=7,
                             deadline_std_s=0.05, seed=3)
    tr = tapps.make_requests(list(tapps.APP_SPECS.values()), per_app=7,
                             deadline_std_s=0.05, seed=3)
    assert [(r.rid, r.app, r.arrival_s, r.deadline_s, r.true_label) for r in jr] == [
        (r.rid, r.app, r.arrival_s, r.deadline_s, r.true_label) for r in tr
    ]
    assert all(a.features.tobytes() == b.features.tobytes() for a, b in zip(jr, tr))


def test_convert_round_trip(suites):
    """JAX objects -> arrays -> port objects -> arrays is the identity, and
    the converted port objects compute what the JAX ones compute."""
    j_apps, j_sneaks, _, _ = suites
    for name, app in j_apps.items():
        arrays = convert.application_to_arrays(app)
        t_app = convert.application_from_arrays(**arrays)
        back = convert.application_to_arrays(t_app)
        assert back.keys() == arrays.keys()
        for key, value in arrays.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(back[key], value)
            else:
                assert back[key] == value
        theta = np.full(app.num_classes, 1.0 / app.num_classes)
        np.testing.assert_array_equal(t_app.accuracies(theta), app.accuracies(theta))

        sp_arrays = convert.knn_sneakpeek_to_arrays(j_sneaks[name])
        t_sp = convert.knn_sneakpeek_from_arrays(**sp_arrays, device="cpu")
        back = convert.knn_sneakpeek_to_arrays(t_sp)
        for key, value in sp_arrays.items():
            np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(value))
        np.testing.assert_array_equal(t_sp.measured_recalls(),
                                      j_sneaks[name].measured_recalls())
        queries = j_sneaks[name]._hold_x[:25]
        np.testing.assert_array_equal(t_sp.votes(queries).numpy(),
                                      j_sneaks[name]._votes(queries))


# ------------------------------------------------------- rules of the port


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port (the launchers and the distribution
    among them), ``chip_smoke.py`` and the gloo ranks' helper of
    tests/test_torch_launch.py and of tests/test_torch_dryrun.py."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "_torch_ranks.py",
        REPO / "tests" / "_torch_tp_ranks.py"]
    assert len(files) > 20
    names = {str(path.relative_to(REPO / "src" / "repro_torch")) for path in files
             if "repro_torch" in path.parts}
    assert {"launch/train.py", "launch/serve.py", "launch/mesh.py", "launch/shardings.py",
            "launch/hlo_analysis.py", "distributed/sharding.py", "distributed/policies.py",
            "distributed/fsdp.py", "serving/profiles.py", "configs/shapes.py",
            "launch/memmodel.py", "launch/costmodel.py", "launch/dryrun.py"} <= names
    bad = [
        f"{path.relative_to(REPO)}: {mod}"
        for path in files
        for mod in _imported_modules(path)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, "the port imports JAX or the JAX package:\n" + "\n".join(bad)


def test_entry_points_need_cuda_unless_cpu_is_named(suites):
    """No silent fallback: without ``device="cpu"`` an entry point raises
    on a host without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, _, t_apps, t_sneaks = suites
    spec = tapps.APP_SPECS["voice_commands"]
    reqs = tapps.make_requests([spec], per_app=3, seed=0)
    policy = tsched.make_policy("SneakPeek")
    calls = [
        lambda: tapps.make_sneakpeek(spec, train_n=50),
        lambda: tsched.schedule_window(policy, reqs, t_apps, 0.1),
        lambda: t_run_window(policy, reqs, t_apps, 0.1),
        lambda: TSimulation(policy, t_apps),
        lambda: t_ingest(reqs, t_apps, t_sneaks),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("option", ["pipeline", "chunk", "shard", "prebatch"])
def test_unported_options_raise(suites, option):
    """``pipeline``, its speculative chunks (``chunk`` > 0, ROADMAP item 5),
    ``prebatch`` and sharding (``shard``, item 11) are ported
    (tests/test_torch_pipeline.py, tests/test_torch_shard.py) and run with
    the reference's values, alone or beside the others: nothing of them
    raises any more."""
    from repro_torch.core.shard import ShardedWindowPipeline

    _, _, t_apps, _ = suites
    if option == "shard":
        assert tsched.make_policy("LO-EDF", shard=1).shard == 1
        assert not hasattr(tsched, "NOT_PORTED")
        return
    if option == "pipeline":
        assert tsched.make_policy("LO-EDF", pipeline=True, chunk=4).chunk == 4
        policy = tsched.make_policy("LO-EDF", pipeline=True, chunk=4, shard=2)
        assert (policy.pipeline, policy.chunk, policy.shard) == (True, 4, 2)
    elif option == "chunk":
        assert tsched.make_policy("LO-EDF", chunk=1).chunk == 1
    else:
        sim = TSimulation(tsched.make_policy("LO-EDF"), t_apps, device="cpu", prebatch=4,
                          pipeline=True, chunk=4)
        assert sim.prebatch == 4 and sim._pipeline.chunk == 4
        sim = TSimulation(tsched.make_policy("LO-EDF"), t_apps, device="cpu", prebatch=4,
                          pipeline=True, chunk=4, shard=True)
        assert sim.prebatch == 4 and isinstance(sim._pipeline, ShardedWindowPipeline)
        assert sim._pipeline.chunk == 4
