"""The port's multi-worker path (Eq. 15 placement, the executor pool and
its lanes, CompiledBackend, SimulatedBackend) against the JAX package's.

On the CPU (``device="cpu"``), from the same seeds:

* placement: ``schedule_window(workers=...)`` and ``multiworker_schedule``
  give the decision tuples of the reference's numpy fast path and of its
  scalar loop (the compiled JAX pipeline does not run on the installed
  JAX, ROADMAP C1), for the five policies, the four worker pools of
  tests/test_pipeline.py, theta all/some/none, carried state, a
  residency budget that evicts, drift scales and a worker mask;
* the placement tile: the means of the one K1 launch per placement step
  equal the reference's ``sequential_mean`` of its (W, B, M) tile bit
  for bit;
* ``Simulation(workers=..., memory_capacity_bytes=...)``;
* ``EdgeServer(workers=[Worker(0), Worker(1, speed=2.0)])`` on reduced
  mamba2-130m and tinyllama-1.1b with serial, thread and process lanes,
  held by the rules of tests/test_torch_serving.py;
* ``CompiledBackend`` (bucketed shapes, continuous batching, footprints,
  the unrecorded first run of a shape, tokens) and ``SimulatedBackend``.

Also: the options the port still refuses, and the launch counters under
threads.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest

from repro.core import POLICY_NAMES
from repro.core import Application as JApplication
from repro.core import ModelProfile as JModelProfile
from repro.core import Request as JRequest
from repro.core import Simulation as JSimulation
from repro.core import StreamingState as JStreamingState
from repro.core import Worker as JWorker
from repro.core import evaluate as j_evaluate
from repro.core import make_policy as j_make_policy
from repro.core import multiworker_schedule as j_multiworker
from repro.core import schedule_window as j_schedule_window
from repro.core.fastpath import sequential_mean as j_sequential_mean
from repro.core.fastpath import utility_matrix as j_utility_matrix
from repro.core.residency import touch_lru_array as j_touch_lru_array
from repro.core.sneakpeek import KNNSneakPeek as JKNNSneakPeek
from repro.core.sneakpeek import attach_sneakpeek as j_attach
from repro.data import applications as japps
from repro.serving import EdgeServer as JEdgeServer
from repro.serving import LMExecutor as JLMExecutor
from repro.serving import SimulatedBackend as JSimulatedBackend
from repro.serving.backends import CompiledBackend as JCompiledBackend
from repro.serving.backends import _bucket_batch as j_bucket_batch
from repro.serving.backends import _bucket_seq as j_bucket_seq
from repro_torch import convert, kernels
from repro_torch.core import fastpath as tfast
from repro_torch.core import scheduler as tsched
from repro_torch.core.accuracy import ModelProfile
from repro_torch.core.evaluation import evaluate as t_evaluate
from repro_torch.core.multiworker import Worker
from repro_torch.core.multiworker import multiworker_schedule as t_multiworker
from repro_torch.core.residency import touch_lru_array
from repro_torch.core.simulator import Simulation as TSimulation
from repro_torch.core.sneakpeek import KNNSneakPeek
from repro_torch.core.sneakpeek import attach_sneakpeek as t_attach
from repro_torch.core.streaming import StreamingState
from repro_torch.core.types import Application, Request
from repro_torch.data import applications as tapps
from repro_torch.serving.backends import (
    CompiledBackend,
    CostModelBackend,
    ProfiledBackend,
    SimulatedBackend,
    _bucket_batch,
    _bucket_seq,
)
from repro_torch.serving.runtime import ExecutorPool, LMExecutor, ProcessLaneBackend
from repro_torch.serving.server import EdgeServer
from test_torch_serving import (
    FAMILY_PROFILES,
    J_FAMILIES,
    NEW_TOKENS,
    TOKEN_TOL,
    _apps,
    _check_served,
    _executors,
    _features,
    _margins,
    _port_variants,
    _trace,
    prompt_fn,
)

# The four pools of tests/test_pipeline.py:27, as (wid, speed, load_scale).
POOLS = [
    [(0, 1.0, 1.0), (1, 1.0, 1.0)],
    [(0, 1.0, 1.0), (1, 2.0, 1.0)],
    [(0, 1.5, 2.0), (1, 1.0, 1.0), (2, 0.5, 1.0)],
    [(3, 2.0, 1.0), (7, 1.0, 0.5)],
]
POOL_IDS = ["even", "one-fast", "three", "sparse-ids"]
THETA_MODES = ["all", "some", "none"]
# A residency budget that evicts: the largest variant (fusion, 600 MiB)
# resides alone, two mid-sized ones do not fit together.
CAPACITIES = [None, 400 * 2**20]
# Recalls that make SneakPeek's label split send one class to each family
# on the pool (as chip_smoke.py's serving phases set them).
POOL_PROFILES = [("mamba2-130m", [0.88, 0.70], 0.010, 0.02),
                 ("tinyllama-1.1b", [0.78, 0.86], 0.030, 0.06)]


def _pool(spec, cls):
    return [cls(wid, speed=speed, load_scale=load) for wid, speed, load in spec]


def _sig(sched):
    return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
             e.est_latency_s) for e in sched.sorted_entries()]


@pytest.fixture(scope="module")
def suites():
    """(JAX apps, JAX numpy-backed sneakpeeks, port apps, port sneakpeeks)."""
    j_apps, j_sneaks = japps.build_benchmark_suite(backend="numpy", seed=0)
    t_apps, t_sneaks = tapps.build_benchmark_suite(seed=0, device="cpu")
    return j_apps, j_sneaks, t_apps, t_sneaks


def _windows(suites, seed, theta, per_app=6, start_rid=0, shift=0.0):
    """One window for each package, as tests/test_pipeline.py builds it."""
    j_apps, j_sneaks, t_apps, t_sneaks = suites
    out = []
    for mod, apps, sneaks, attach in (
            (japps, j_apps, j_sneaks, j_attach),
            (tapps, t_apps, t_sneaks, lambda r, a, s: t_attach(r, a, s, device="cpu"))):
        reqs = mod.make_requests(list(mod.APP_SPECS.values()), per_app=per_app,
                                 deadline_std_s=0.05, seed=seed, start_rid=start_rid)
        for r in reqs:
            r.arrival_s += shift
            r.deadline_s += shift
        if theta != "none":
            attach(reqs, apps, sneaks)
            if theta == "some":
                for r in reqs[::3]:
                    r.theta = None
                    r.evidence = None
        out.append(reqs)
    return out


# ------------------------------------------------------------- placement


@pytest.mark.parametrize("theta", THETA_MODES)
@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_schedule_window_workers_matches_reference(suites, policy, pool, theta):
    """The port's placement (fast path through K1's plain version, and its
    scalar loop) gives the reference's fast and scalar decisions."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, POOLS.index(pool), theta)
    want, _ = j_schedule_window(j_make_policy(policy), j_reqs, j_apps, 0.1,
                                workers=_pool(pool, JWorker))
    scalar, _ = j_schedule_window(j_make_policy(policy, fastpath=False), j_reqs, j_apps, 0.1,
                                  workers=_pool(pool, JWorker))
    assert _sig(scalar) == _sig(want)
    got, _ = tsched.schedule_window(tsched.make_policy(policy), t_reqs, t_apps, 0.1,
                                    workers=_pool(pool, Worker), device="cpu")
    host, _ = tsched.schedule_window(tsched.make_policy(policy, fastpath=False), t_reqs,
                                     t_apps, 0.1, workers=_pool(pool, Worker), device="cpu")
    assert _sig(got) == _sig(want)
    assert _sig(host) == _sig(want)
    assert {e.worker for e in got.entries} <= {w for w, _, _ in pool}


@pytest.mark.parametrize("capacity", CAPACITIES, ids=["single-slot", "evicting"])
@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("policy", ["LO-EDF", "SneakPeek"])
def test_multiworker_carried_state_matches_reference(suites, policy, pool, capacity):
    """Four windows, each scheduled against the state the previous ones
    committed (backlog and LRU residency under the capacity), on the
    reference's fast and scalar paths and the port's two: equal decisions
    in every window and equal residency at the end."""
    j_apps, _, t_apps, _ = suites
    jp, tp = j_make_policy(policy), tsched.make_policy(policy)
    wids = [w for w, _, _ in pool]
    chains = {}
    for name, fast in (("j-fast", True), ("j-scalar", False), ("t-fast", True),
                       ("t-scalar", False)):
        cls = JStreamingState if name[0] == "j" else StreamingState
        chains[name] = (cls(worker_ids=wids, memory_capacity_bytes=capacity), fast)
    for w in range(4):
        now = 0.1 * (w + 1)
        j_reqs, t_reqs = _windows(suites, 30 + w, "some", per_app=5, start_rid=100 * w,
                                  shift=0.1 * w)
        sigs = {}
        for name, (state, fast) in chains.items():
            if name[0] == "j":
                sched = j_multiworker(j_reqs, j_apps, _pool(pool, JWorker), now,
                                      data_aware=jp.data_aware,
                                      split_by_label=jp.split_by_label,
                                      per_request=not jp.grouped, fastpath=fast, state=state)
                j_evaluate(sched, j_apps, now, acc_mode="oracle", state=state)
            else:
                sched = t_multiworker(t_reqs, t_apps, _pool(pool, Worker), now,
                                      data_aware=tp.data_aware,
                                      split_by_label=tp.split_by_label,
                                      per_request=not tp.grouped, fastpath=fast, state=state,
                                      device="cpu")
                t_evaluate(sched, t_apps, now, acc_mode="oracle", state=state, device="cpu")
            sigs[name] = _sig(sched)
        assert sigs["t-fast"] == sigs["t-scalar"] == sigs["j-fast"] == sigs["j-scalar"], w
    j_state = chains["j-fast"][0]
    for state, _ in chains.values():
        assert {wid: list(tl._resident) for wid, tl in state.items()} == {
            wid: list(tl._resident) for wid, tl in j_state.items()}


@pytest.mark.parametrize("pool", POOLS[1:3], ids=POOL_IDS[1:3])
def test_lat_scale_and_worker_mask_match_reference(suites, pool):
    """Drift scales multiply the fast path's latency tables and its
    tie-break; a worker mask keeps placement off the other workers; the
    scalar loop refuses scales, as the reference's does."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, 7, "all")
    wids = [w for w, _, _ in pool]
    names = [m.name for app in t_apps.values() for m in app.models]
    scale = {(wid, name): 1.0 + 0.25 * ((k + i) % 3)
             for k, wid in enumerate(wids) for i, name in enumerate(names)}
    mask = set(wids[1:])
    for kwargs in ({"lat_scale": scale}, {"worker_mask": mask},
                   {"lat_scale": scale, "worker_mask": mask}):
        want, _ = j_schedule_window(j_make_policy("SneakPeek"), j_reqs, j_apps, 0.1,
                                    workers=_pool(pool, JWorker), **kwargs)
        got, _ = tsched.schedule_window(tsched.make_policy("SneakPeek"), t_reqs, t_apps, 0.1,
                                        workers=_pool(pool, Worker), device="cpu", **kwargs)
        assert _sig(got) == _sig(want)
        if "worker_mask" in kwargs:
            assert {e.worker for e in got.entries} <= mask
    want = j_multiworker(j_reqs, j_apps, _pool(pool, JWorker), 0.1, fastpath=False,
                         worker_mask=mask)
    got = t_multiworker(t_reqs, t_apps, _pool(pool, Worker), 0.1, fastpath=False,
                        worker_mask=mask, device="cpu")
    assert _sig(got) == _sig(want)
    with pytest.raises(ValueError, match="lat_scale"):
        t_multiworker(t_reqs, t_apps, _pool(pool, Worker), 0.1, fastpath=False,
                      lat_scale=scale, device="cpu")
    with pytest.raises(ValueError, match="multi-worker"):
        tsched.schedule_window(tsched.make_policy("SneakPeek"), t_reqs, t_apps, 0.1,
                               lat_scale=scale, device="cpu")


@pytest.mark.parametrize("shape", [(1, 2, 3), (7, 3, 5), (40, 2, 6)], ids=str)
@pytest.mark.parametrize("penalty", ["step", "linear", "sigmoid", "none"])
def test_placement_means_equal_sequential_mean(penalty, shape):
    """The (W*M,) means of one K1 launch over the (B, W*M) tile (the CPU
    path: its plain version) are bit-identical to the reference's
    ``sequential_mean`` of its (W, B, M) tile, on near-deadline
    completions where the penalties bend."""
    import torch

    b, w, m = shape
    rng = np.random.default_rng([b, w, m])
    acc = rng.uniform(0.3, 0.99, (b, m))
    deadlines = rng.uniform(0.05, 0.4, b)
    completions = rng.uniform(0.02, 0.5, (w, m))
    tile = j_utility_matrix(acc[None], deadlines[None, :, None], completions[:, None, :],
                            penalty, backend="numpy")
    want = j_sequential_mean(tile, axis=1).ravel()
    got = tfast.placement_means(torch.as_tensor(acc), torch.as_tensor(deadlines),
                                completions.ravel(), penalty)
    assert got.tobytes() == want.tobytes()


def test_placement_scores_each_group_in_one_kernel_call(suites, monkeypatch):
    """One call of the Eq. 2 kernel's wrapper per placement step, with the
    column sums, over a (B, W*M) tile."""
    _, _, t_apps, _ = suites
    _, t_reqs = _windows(suites, 3, "all")
    calls = []
    real = tfast.utility_scores

    def spy(acc, deadlines, completions, penalty="sigmoid", with_means=True):
        calls.append((tuple(acc.shape), tuple(completions.shape), with_means))
        return real(acc, deadlines, completions, penalty, with_means)

    monkeypatch.setattr(tfast, "utility_scores", spy)
    pool = _pool(POOLS[2], Worker)
    sched = t_multiworker(t_reqs, t_apps, pool, 0.1, data_aware=True, split_by_label=True,
                          device="cpu")
    groups = sorted({e.batch_id for e in sched.entries})
    assert len(calls) == len(groups) > 1
    for (b, cols), comp, with_means in calls:
        assert with_means and cols % len(pool) == 0 and comp == (cols,)
    assert sum(b for (b, _), _, _ in calls) == len(t_reqs)


def test_touch_lru_array_matches_reference():
    """The array form of the LRU rule, load by load, under unit and byte
    sizes, against the reference's."""
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 9, 6).astype(np.float64)
    for capacity in (0.0, 8.0, 12.0, 100.0):
        jres = tres = np.full(6, -1, dtype=np.int64)
        for gid in rng.integers(0, 6, 40):
            jres, jhit = j_touch_lru_array(jres, int(gid), sizes, capacity)
            tres, thit = touch_lru_array(tres, int(gid), sizes, capacity)
            assert np.array_equal(tres, jres) and thit == jhit


@pytest.mark.parametrize("capacity", CAPACITIES, ids=["single-slot", "evicting"])
@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
def test_simulation_with_workers_matches_reference(pool, capacity):
    """Three streamed windows over a pool with carried backlog and
    residency: the same aggregate metrics, per-window log and residency."""
    j_apps, j_sneaks = japps.build_benchmark_suite(backend="numpy", seed=1)
    t_apps, t_sneaks = tapps.build_benchmark_suite(seed=1, device="cpu")

    def trace(mod):
        out = []
        for w in range(3):
            reqs = mod.make_requests(list(mod.APP_SPECS.values()), per_app=8,
                                     deadline_std_s=0.05, seed=40 + w, start_rid=30 * w)
            for r in reqs:
                r.arrival_s += 0.1 * w
                r.deadline_s += 0.1 * w
            out.extend(reqs)
        return out

    j_sim = JSimulation(j_make_policy("SneakPeek"), j_apps, sneakpeeks=j_sneaks,
                        short_circuit=True, seed=3, workers=_pool(pool, JWorker),
                        memory_capacity_bytes=capacity)
    t_sim = TSimulation(tsched.make_policy("SneakPeek"), t_apps, sneakpeeks=t_sneaks,
                        short_circuit=True, seed=3, workers=_pool(pool, Worker),
                        memory_capacity_bytes=capacity, device="cpu")
    j_out = j_sim.run(trace(japps))
    t_out = t_sim.run(trace(tapps))
    assert t_out == j_out
    assert len(t_sim.log) == len(j_sim.log) == 3
    for t_row, j_row in zip(t_sim.log, j_sim.log):
        for key in ("window", "n", "violations", "utility", "backlog_s", "utilization"):
            assert t_row[key] == j_row[key], key
    assert t_sim.state.resident_models() == {
        w: list(tl._resident) for w, tl in j_sim.state.items()}


# ------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def knn_split():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 2, 400).astype(np.int32)
    return _features(rng, y), y


def _serve_pool(policy, knn_split, profiles, n, lane):
    """Serve the trace through the reference's pool (thread lanes) and the
    port's (``lane``), both wrapping an executor over identical weights."""
    x, y = knn_split
    jexec, texec = _executors(J_FAMILIES)
    jsneaks = tsneaks = None
    if policy == "SneakPeek":
        jsneaks = {"assistant": JKNNSneakPeek(x, y, 2, k=5, backend="numpy")}
        tsneaks = {"assistant": KNNSneakPeek(x, y, 2, k=5, device="cpu")}
    with JEdgeServer(_apps(JModelProfile, JApplication, profiles), j_make_policy(policy),
                     executor=jexec, sneakpeeks=jsneaks, prompt_fn=prompt_fn,
                     workers=[JWorker(0), JWorker(1, speed=2.0)]) as jsrv:
        jouts, jstats = jsrv.run(_trace(JRequest, n=n))
    with EdgeServer(_apps(ModelProfile, Application, profiles), make_policy(policy),
                    executor=texec, sneakpeeks=tsneaks, prompt_fn=prompt_fn,
                    workers=[Worker(0), Worker(1, speed=2.0)], lane=lane,
                    device="cpu") as tsrv:
        assert isinstance(tsrv.pool, ExecutorPool) and tsrv.pool.lane == lane
        touts, tstats = tsrv.run(_trace(Request, n=n))
    return jexec, jouts, jstats, touts, tstats


def make_policy(name):
    return tsched.make_policy(name)


@pytest.mark.parametrize("policy,profiles,n,lane", [
    ("SneakPeek", POOL_PROFILES, 16, "serial"),
    ("SneakPeek", POOL_PROFILES, 16, "thread"),
    ("SneakPeek", POOL_PROFILES, 16, "process"),
    ("Grouped", FAMILY_PROFILES, 24, "thread"),
], ids=["sneakpeek-serial", "sneakpeek-thread", "sneakpeek-process", "grouped-thread"])
def test_edge_server_pool_matches_reference(knn_split, policy, profiles, n, lane):
    """Reduced mamba2-130m and tinyllama-1.1b on two workers, one twice as
    fast: equal statistics and per-worker swaps, the same batches on the
    same workers and models, equal tokens where the reference's margin
    clears the tolerance, and both families serving."""
    jexec, jouts, jstats, touts, tstats = _serve_pool(policy, knn_split, profiles, n, lane)
    _check_served(jexec, jouts, jstats, touts, tstats, J_FAMILIES)
    assert tstats.worker_swaps == jstats.worker_swaps
    assert set(tstats.pool_busy_s) == set(jstats.pool_busy_s) == {0, 1}
    assert tstats.worker_utilization.keys() == jstats.worker_utilization.keys()
    for w, u in tstats.worker_utilization.items():
        assert u == jstats.worker_utilization[w]
    jplaced = [(r.worker, r.request_ids, r.model) for o in jouts for r in o["reports"]]
    tplaced = [(r.worker, r.request_ids, r.model) for o in touts for r in o["reports"]]
    assert tplaced == jplaced
    if policy == "SneakPeek":
        assert {w for w, _, _ in tplaced} == {0, 1}
    for o in touts:
        for r in o["reports"]:
            assert r.prefill_s > 0 and r.decode_s > 0


def _sim_profiles(cls):
    return {
        "small": cls("small", recalls=[0.74, 0.72], latency_s=0.010, load_latency_s=0.02,
                     memory_bytes=3_000),
        "big": cls("big", recalls=[0.93, 0.91], latency_s=0.045, load_latency_s=0.08,
                   latency_model=(0.025, 0.02), memory_bytes=5_000),
    }


def _sim_serve(mods, lane, occupancy="none"):
    """Serve 18 requests over ~4 windows on a two-worker pool of
    SimulatedBackend lanes under a residency budget."""
    server_cls, backend_cls, profile_cls, app_cls, request_cls, worker_cls, policy, extra = mods
    profiles = _sim_profiles(profile_cls)
    app = app_cls(name="lm", models=list(profiles.values()), penalty="sigmoid")
    backend = backend_cls(profiles, occupancy=occupancy, time_scale=1e-3)
    srv = server_cls({"lm": app}, policy("LO-EDF"), backend=backend,
                     prompt_fn=lambda r: (np.arange(8, dtype=np.int32) + int(r.rid)) % 256,
                     workers=[worker_cls(0), worker_cls(1, speed=2.0)], lane=lane,
                     memory_capacity_bytes=7_000, **extra)
    reqs = [request_cls(rid=i, app="lm", arrival_s=0.02 * i, deadline_s=0.02 * i + 0.3,
                        true_label=i % 2) for i in range(18)]
    with srv:
        outs, stats = srv.run(reqs)
    reports = [(r.worker, r.request_ids, r.model, r.batch_size, r.swap_s, r.prefill_s,
                r.decode_s, list(r.predictions)) for o in outs for r in o["reports"]]
    return reports, stats


J_SIM = (JEdgeServer, JSimulatedBackend, JModelProfile, JApplication, JRequest, JWorker,
         j_make_policy, {})
T_SIM = (EdgeServer, SimulatedBackend, ModelProfile, Application, Request, Worker,
         make_policy, {"device": "cpu"})


@pytest.mark.parametrize("lane", ["serial", "thread", "process"])
def test_simulated_backend_pool_matches_reference(lane):
    """A pool of SimulatedBackend lanes (no model) with a residency budget
    the backend's footprints fill: identical reports, swaps and stats."""
    want, jstats = _sim_serve(J_SIM, "thread")
    got, tstats = _sim_serve(T_SIM, lane)
    assert got == want
    assert len({w for w, *_ in got}) == 2
    for key in ("windows", "requests", "violations", "swaps", "mean_utility",
                "worker_busy_s", "span_s", "worker_swaps", "pool_busy_s",
                "profile_provenance"):
        assert getattr(tstats, key) == getattr(jstats, key), key


@pytest.mark.parametrize("occupancy", ["none", "sleep", "spin"])
def test_simulated_backend_matches_reference(occupancy):
    """Reports, fit, footprints and swap costs equal the reference's for
    every occupancy; the backend holds no tensor and spawns its twin."""
    jb = JSimulatedBackend(_sim_profiles(JModelProfile), occupancy=occupancy, time_scale=1e-3)
    tb = SimulatedBackend(_sim_profiles(ModelProfile), occupancy=occupancy, time_scale=1e-3)
    for name in ("small", "big", "small"):
        for b in (1, 3):
            prompts = np.zeros((b, 5), np.int32)
            jr = jb.run_batch(name, prompts, list(range(7, 7 + b)))
            tr = tb.run_batch(name, prompts, list(range(7, 7 + b)))
            for key in ("request_ids", "model", "batch_size", "swap_s", "prefill_s",
                        "decode_s", "predictions"):
                assert getattr(tr, key) == getattr(jr, key), key
            assert np.array_equal(tr.tokens, jr.tokens)
        assert tb.affine(name) == jb.affine(name)
        assert tb.model_bytes(name) == jb.model_bytes(name)
        assert tb.swap_cost(name) == jb.swap_cost(name)
        assert tb.latency_model(name, 4) == jb.latency_model(name, 4)
    twin = tb.spawn()
    assert isinstance(twin, SimulatedBackend) and twin.occupancy == occupancy
    assert twin._obs == {} and twin.profiles == tb.profiles
    with pytest.raises(ValueError, match="occupancy"):
        SimulatedBackend(_sim_profiles(ModelProfile), occupancy="busy")


# ------------------------------------------------------- CompiledBackend


def _compiled_pair(variants=J_FAMILIES, **kwargs):
    """(reference CompiledBackend, port CompiledBackend on the CPU) over
    identical weights (the reference's ``LM.init``, converted)."""
    jcb = JCompiledBackend(variants, new_tokens=NEW_TOKENS, **kwargs)
    tcb = CompiledBackend(_port_variants(variants), new_tokens=NEW_TOKENS, device="cpu",
                          **kwargs)
    for name in variants:
        _, jparams = jcb._get(name)
        tcb.set_params(name, convert.lm_params_from_arrays(
            tcb.variants[name][0], jax.tree.map(np.asarray, jparams), device="cpu"))
    return jcb, tcb


def test_compiled_backend_buckets_like_the_reference():
    """Batch to the next power of two, sequence to a multiple, zeros on the
    right: the same padded arrays as the reference's."""
    for b in range(1, 40):
        assert _bucket_batch(b) == j_bucket_batch(b)
    for s in range(1, 80):
        for mult in (1, 8, 16):
            assert _bucket_seq(s, mult) == j_bucket_seq(s, mult)
    jcb = JCompiledBackend({}, seq_multiple=8)
    tcb = CompiledBackend({}, seq_multiple=8, device="cpu")
    rng = np.random.default_rng(0)
    for b, s in ((1, 8), (3, 5), (4, 8), (5, 9), (8, 17)):
        prompts = rng.integers(1, 100, (b, s)).astype(np.int32)
        got = tcb._pad(prompts)
        assert got.shape == (_bucket_batch(b), _bucket_seq(s, 8))
        assert np.array_equal(got, jcb._pad(prompts))


def test_compiled_backend_tokens_match_reference():
    """Bucketed forwards of both families, padded rows included, against
    the reference's: tokens equal wherever the reference's top-2 margin
    clears the tolerance; decode runs one graph key per (variant, bucketed
    batch, capacity), each on its own cache."""
    jcb, tcb = _compiled_pair()
    jexec, _ = _executors(J_FAMILIES)
    rng = np.random.default_rng(5)
    vocab = min(cfg.vocab_size for cfg, _ in J_FAMILIES.values())
    compared = 0
    for name in J_FAMILIES:
        for b, s in ((3, 5), (2, 12), (3, 7)):
            padded = tcb._pad(rng.integers(0, vocab, (b, s)).astype(np.int32))
            _, _, jtok, _ = jcb._forward(name, padded, None)
            _, _, ttok, _ = tcb._forward(name, padded, None)
            assert ttok.shape == jtok.shape == (padded.shape[0], NEW_TOKENS)
            ref = dataclasses.make_dataclass("R", ["model", "tokens"])(name, jtok)
            clear = np.cumprod(_margins(jexec, ref, padded) > TOKEN_TOL, axis=1).astype(bool)
            np.testing.assert_array_equal(ttok[clear], jtok[clear])
            compared += int(clear.sum())
    assert compared > 0
    assert sorted(tcb._decoders, key=str) == sorted(
        [("mamba2-130m", 4, None), ("mamba2-130m", 2, None),
         ("tinyllama-1.1b", 4, 256), ("tinyllama-1.1b", 2, 256)], key=str)
    assert tcb._caches == {}  # no cache shared between keys


def test_compiled_backend_first_run_of_a_shape_is_not_recorded():
    """The ``_warm`` rule: a (variant, bucketed batch, bucketed length)'s
    first run feeds no observation, its later runs do; the fit
    self-calibrates from batches of 1 and 2 when asked first, and clamps
    as the reference's does."""
    _, tcb = _compiled_pair({"m": J_FAMILIES["mamba2-130m"]})
    fixed, per_item = tcb.affine("m")  # calibrates: (1, 8) and (2, 8) twice each
    assert fixed >= 0.0 and per_item >= 0.0 and fixed + per_item > 0.0
    assert tcb._warm == {("m", 1, 8), ("m", 2, 8)}
    assert [b for b, _ in tcb._obs["m"]] == [1, 2]
    prompts = np.ones((3, 11), np.int32)
    for k in range(3):
        tcb.run_batch("m", prompts, [0, 1, 2])
        assert len(tcb._obs["m"]) == 2 + k  # the first (4, 16) run unrecorded
    assert ("m", 4, 16) in tcb._warm
    assert all(b in (1, 2, 4) for b, _ in tcb._obs["m"])
    profile = tcb.profile("m", [0.9, 0.8])
    assert profile.provenance == "realized" and profile.latency_s > 0


def test_compiled_backend_run_batches_split_like_the_reference():
    """Continuous batching: two scheduled batches fused into one forward,
    reports split back by rows; through ``LMExecutor.execute_schedule``
    consecutive same-model batches fuse and the swap is charged once."""
    jcb, tcb = _compiled_pair({"m": J_FAMILIES["mamba2-130m"]})
    prompts = [np.ones((2, 4), np.int32), np.full((3, 6), 2, np.int32)]
    jreps = jcb.run_batches("m", prompts, [[10, 11], [20, 21, 22]])
    treps = tcb.run_batches("m", prompts, [[10, 11], [20, 21, 22]])
    for tr, jr in zip(treps, jreps):
        assert (tr.request_ids, tr.batch_size, tr.tokens.shape) == (
            jr.request_ids, jr.batch_size, jr.tokens.shape)
    assert treps[1].prefill_s == pytest.approx(treps[0].prefill_s * 1.5)
    assert treps[1].decode_s == pytest.approx(treps[0].decode_s * 1.5)
    from repro.core.types import Schedule as JSchedule
    from repro.core.types import ScheduleEntry as JEntry
    from repro_torch.core.types import Schedule, ScheduleEntry

    def schedule(req_cls, entry_cls, sched_cls):
        entries = [entry_cls(request=req_cls(rid=i, app="app", arrival_s=0.0,
                                             deadline_s=60.0, true_label=0),
                             model="m", order=i + 1, batch_id=i // 2) for i in range(4)]
        return sched_cls(entries=entries)

    jex, tex = JLMExecutor(backend=jcb), LMExecutor(backend=tcb)
    jr = jex.execute_schedule(schedule(JRequest, JEntry, JSchedule), prompt_fn)
    tr = tex.execute_schedule(schedule(Request, ScheduleEntry, Schedule), prompt_fn)
    assert [(r.request_ids, r.swap_s) for r in tr] == [(r.request_ids, r.swap_s) for r in jr]
    assert tr[0].swap_s > 0 and tr[1].swap_s == 0.0 and tex.swaps.swap_count == 1


def test_compiled_backend_model_bytes_match_reference():
    """Weights plus the KV cache at the hints, for both families and
    gemma-7b's head dim 256, against the reference's ``weight_bytes +
    cache_bytes``; swap costs follow."""
    from repro.configs import ARCHS as J_ARCHS

    variants = dict(J_FAMILIES, **{"gemma-7b": (J_ARCHS["gemma-7b"].reduced(), 2)})
    for kwargs in ({}, {"batch_hint": 3, "max_len_hint": 100, "seq_multiple": 16}):
        jcb = JCompiledBackend(variants, new_tokens=NEW_TOKENS, **kwargs)
        tcb = CompiledBackend(_port_variants(variants), new_tokens=NEW_TOKENS, device="cpu",
                              **kwargs)
        for name in variants:
            assert tcb.model_bytes(name) == jcb.model_bytes(name)
            assert tcb.swap_cost(name) == jcb.swap_cost(name)
            for b, s in ((1, 64), (4, 300)):
                assert tcb.model_bytes(name, b, s) == jcb.model_bytes(name, b, s)
            assert tcb.model_bytes(name, 4, 64) > tcb.model_bytes(name, 1, 64)
    # A realized backend's footprints size the scheduler's residency.
    app = _apps(ModelProfile, Application, FAMILY_PROFILES)
    srv = EdgeServer(app, make_policy("Grouped"), backend=tcb, device="cpu",
                     memory_capacity_bytes=10**9, workers=[Worker(0), Worker(1)])
    assert srv.state.timeline(1)._profiles == {n: tcb.model_bytes(n) for n in variants}
    assert srv.pool.lanes[0].executor.swaps.capacity == 10**9


# ---------------------------------------------------------------- lanes


def test_process_lane_refuses_a_backend_that_has_run():
    """A process lane's template must be fresh; one that has built decode
    buffers is refused with a message, and its spawn crosses (carried
    weights as arrays) and serves the same tokens in the child."""
    _, texec = _executors({"m": J_FAMILIES["mamba2-130m"]})
    backend = texec.backend
    prompts = np.ones((2, 9), np.int32)
    mine = backend.run_batch("m", prompts, [0, 1])
    lane = ProcessLaneBackend(backend)
    with pytest.raises(TypeError, match="fresh backend"):
        lane.run_batch("m", prompts, [0, 1])
    lane.close()
    lane = ProcessLaneBackend(backend.spawn())
    try:
        theirs = lane.run_batch("m", prompts, [0, 1])
    finally:
        lane.close()
    np.testing.assert_array_equal(theirs.tokens, mine.tokens)
    assert lane._proc is None


def test_pool_lanes_share_the_weights_of_their_parent():
    """Thread lanes spawned from one backend read one copy of the weights
    (``set_params`` ones included) and own their graphs and caches."""
    _, texec = _executors({"m": J_FAMILIES["tinyllama-1.1b"]})
    pool = ExecutorPool.from_executor(texec, [Worker(0), Worker(1)])
    backends = [lane.executor.backend for lane in pool.lanes.values()]
    assert all(isinstance(b, ProfiledBackend) for b in backends)
    params = [b._get("m")[1] for b in backends]
    assert params[0] is params[1] is texec.backend._get("m")[1]
    assert backends[0]._decoders is not backends[1]._decoders
    pool.close()
    pool.close()  # idempotent


def test_launch_counts_are_exact_under_threads():
    """Launches counted from more threads than cores at once, switching
    often, add up exactly, and each thread's own tally holds only its
    launches."""
    import sys

    counter = kernels.LaunchCounter("_pool_test_kernel")
    before = kernels.launch_counts()["_pool_test_kernel"]
    tallies = {}
    n_threads = 16

    def work(k):
        start = kernels.thread_launch_counts().get("_pool_test_kernel", 0)
        for _ in range(500 * (k + 1)):
            counter.add()
        kernels.add_launches({"_pool_test_kernel": k})
        tallies[k] = kernels.thread_launch_counts()["_pool_test_kernel"] - start

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    want = {k: 500 * (k + 1) + k for k in range(n_threads)}
    assert tallies == want
    assert kernels.launch_counts()["_pool_test_kernel"] - before == sum(want.values())
    kernels.add_launches({"_pool_test_other": 3})
    assert kernels.launch_counts()["_pool_test_other"] == 3


# ------------------------------------------------ what is still refused


@pytest.mark.parametrize("option,value", [("pipeline", True), ("chunk", 4), ("shard", True)])
def test_workers_with_compiled_options_still_raise(suites, option, value):
    """The pool composes with the compiled pipeline, speculative chunks and
    sharding in the reference, and in the port: ``EdgeServer`` and
    ``Simulation`` with workers keep one pipeline with the chunk and the
    pool, sharded (``core.shard``, ROADMAP item 11) when ``shard`` is
    given, alone or beside the others."""
    from repro_torch.core.shard import ShardedWindowPipeline

    _, _, t_apps, _ = suites
    workers = [Worker(0), Worker(1)]
    kwargs = {option: value, **({"chunk": 4} if option == "pipeline" else {})}
    if option != "shard":
        srv = EdgeServer(_apps(ModelProfile, Application), make_policy("Grouped"),
                         device="cpu", workers=workers, **kwargs)
        sim = TSimulation(tsched.make_policy("LO-EDF"), t_apps, device="cpu", workers=workers,
                          **kwargs)
        for obj in (srv, sim):
            assert obj._pipeline is None or (obj._pipeline.chunk == 4
                                             and obj._pipeline.workers == workers)
        kwargs["shard"] = True
    srv = EdgeServer(_apps(ModelProfile, Application), make_policy("Grouped"), device="cpu",
                     workers=workers, **kwargs)
    sim = TSimulation(tsched.make_policy("LO-EDF"), t_apps, device="cpu", workers=workers,
                      **kwargs)
    for obj in (srv, sim):
        assert isinstance(obj._pipeline, ShardedWindowPipeline)
        assert obj._pipeline.workers == workers and obj._pipeline.shard is True
        assert obj._pipeline.chunk == kwargs.get("chunk")


def test_cost_model_backend_still_raises():
    """``CostModelBackend`` is ported (held against the reference's in
    tests/test_torch_launch.py): it builds, models a batch without running
    one and spawns lanes; an unknown arch name still raises."""
    backend = CostModelBackend({"m": "mamba2-130m"})
    report = backend.spawn().run_batch("m", np.zeros((2, 5), np.int32), [0, 1])
    assert report.batch_size == 2 and report.prefill_s > 0 and report.decode_s > 0
    with pytest.raises(KeyError):
        CostModelBackend({"m": "no-such-arch"})


def test_pool_rejects_unknown_lanes_and_misplaced_pools():
    backend = SimulatedBackend(_sim_profiles(ModelProfile))
    with pytest.raises(ValueError, match="lane"):
        ExecutorPool([Worker(0)], backend_factory=backend.spawn, lane="rocket")
    with pytest.raises(ValueError, match="at least one worker"):
        ExecutorPool([], backend_factory=backend.spawn)
    pool = ExecutorPool([Worker(0)], backend_factory=backend.spawn, lane="serial")
    app = {"lm": Application(name="lm", models=list(_sim_profiles(ModelProfile).values()))}
    with pytest.raises(ValueError, match="workers"):
        EdgeServer(app, make_policy("LO-EDF"), executor=pool, device="cpu")
    with pytest.raises(ValueError, match="conflicts"):
        EdgeServer(app, make_policy("LO-EDF"), executor=pool, workers=[Worker(0)],
                   lane="process", device="cpu")
    srv = EdgeServer(app, make_policy("LO-EDF"), executor=pool, workers=[Worker(0)],
                     device="cpu")
    assert srv.pool is pool
    with pytest.raises(KeyError, match="unpooled"):
        sched, _ = tsched.schedule_window(
            tsched.make_policy("LO-EDF"),
            [Request(rid=0, app="lm", arrival_s=0.0, deadline_s=1.0)], app, 0.1,
            workers=[Worker(5)], device="cpu")
        pool.execute_schedule(sched, prompt_fn)
    srv.close()

