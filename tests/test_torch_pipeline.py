"""The port's compiled window pipeline (``repro_torch.core.pipeline``)
against the JAX package.

On the CPU (``device="cpu"``), where the pipeline's selection scan runs
its plain version (``kernels/selection_scan/ref.py``), from the same
seeds as the reference's windows:

* ``pipeline_schedule`` / ``make_policy(name, pipeline=True)`` give the
  schedules of the reference's numpy fast path and of its scalar loop
  (``make_policy(name, fastpath=False)``), field by field: rid, model,
  order, batch id, worker, and ``est_start_s``/``est_latency_s`` bit-equal.
  The reference's compiled pipeline does not run on the installed JAX
  (ROADMAP C1), and the reference holds its fast path and scalar loop
  decision-identical to it (tests/test_pipeline.py).  The grid: five
  policies x theta all/some/none x no capacity / a capacity that evicts
  x with and without a carried ``StreamingState``, on one worker and on
  the four pools of tests/test_pipeline.py:27 with drift scales and a
  worker mask, plus one long window (1,200 requests: the scan runs
  1,200 sequential steps);
* the plain scan against the reference's own compiled step programs
  (``_grouped_program`` and ``_multiworker_program``, run here under
  ``jax.enable_x64``, the switch C1 breaks in the reference) at the
  edges: one group, M = 1, every model invalid but one, exact ties that
  the first maximum and the preference order decide, an LRU eviction
  chain;
* ``precompute_windows``: rows bit-equal to the lazy per-window compute
  for both backend values, priorities bit-equal to the reference's and
  Eq. 9 rows within 2 ulp of its rows (a BLAS product's last bit);
* ``Simulation(pipeline=True)`` and ``Simulation(prebatch=4,
  prebatch_backend=...)`` against ``prebatch=0``, ``pipeline=False`` and
  the reference's ``Simulation``: the same per-window decisions, log and
  aggregates;
* ``EdgeServer(pipeline=True)`` on ``SimulatedBackend`` lanes,
  synchronous and overlapped, against the reference's ``EdgeServer()``:
  records, decisions, counters and fired faults;
* speculative chunked selection (``chunk`` > 0): the plain chunked scan
  against the reference's chunked programs (``_multiworker_program`` and
  ``_grouped_program`` with ``chunk``, and its whole ``WindowPipeline``
  with ``chunk``, the per-request program included, under
  ``jax.enable_x64``): decisions, starts, latencies, rounds, conflicts
  and ``chunk_stats``; the port's chunked schedules against its
  ``chunk=0`` ones for five policies x chunk 1, 3, 16, > window x slot1
  and LRU, and the four pools with drift scales and masks;
  ``Simulation`` and ``EdgeServer`` with ``chunk=16``;
* ``shard`` on every entry point that refused it before item 11
  (tests/test_torch_shard.py holds the sharded pipeline itself), and a
  pipeline without ``device="cpu"`` on a host without CUDA.

Tolerances: none but the one stated for the Eq. 9 rows.  Decisions and
times are float64 in the reference's association, so every other
compared value is bit-equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import POLICY_NAMES
from repro.core import Simulation as JSimulation
from repro.core import StreamingState as JStreamingState
from repro.core import Worker as JWorker
from repro.core import evaluate as j_evaluate
from repro.core import make_policy as j_make_policy
from repro.core import pipeline as jpipe
from repro.core import schedule_window as j_schedule_window
from repro.core import fastpath as jwindow
from repro.core.fastpath import precompute_windows as j_precompute_windows
from repro.core.sneakpeek import attach_sneakpeek as j_attach
from repro.data import applications as japps
from repro_torch.core import fastpath as tfast
from repro_torch.core import pipeline as tpipe
from repro_torch.core import scheduler as tsched
from repro_torch.core import shard as tshard
from repro_torch.core import simulator as tsim
from repro_torch.core.evaluation import evaluate as t_evaluate
from repro_torch.core.multiworker import Worker
from repro_torch.core.sneakpeek import attach_sneakpeek as t_attach
from repro_torch.core.streaming import StreamingState
from repro_torch.core.utility import PENALTY_CODES
from repro_torch.data import applications as tapps
from repro_torch.kernels.selection_scan.ops import selection_scan
from repro_torch.kernels.spec_scan.ops import spec_scan
from test_torch_closed_loop import T as T_PKG
from test_torch_closed_loop import _reference as closed_loop_reference
from test_torch_closed_loop import _sim_serve

THETA_MODES = ["all", "some", "none"]
# A residency budget that evicts: the largest variant (fusion, 600 MiB)
# resides alone, two mid-sized ones do not fit together.
CAPACITIES = [None, 400 * 2**20]
CAPACITY_IDS = ["single-slot", "evicting"]
# The four pools of tests/test_pipeline.py:27, as (wid, speed, load_scale).
POOLS = [
    [(0, 1.0, 1.0), (1, 1.0, 1.0)],
    [(0, 1.0, 1.0), (1, 2.0, 1.0)],
    [(0, 1.5, 2.0), (1, 1.0, 1.0), (2, 0.5, 1.0)],
    [(3, 2.0, 1.0), (7, 1.0, 0.5)],
]
POOL_IDS = ["even", "one-fast", "three", "sparse-ids"]
# The reference's penalty ids (src/repro/core/pipeline.py:82).
J_PENALTY_ID = {"step": 0, "linear": 1, "sigmoid": 2, "none": 3}


def _pool(spec, cls):
    return [cls(wid, speed=speed, load_scale=load) for wid, speed, load in spec]


def _sig(sched):
    return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
             e.est_latency_s) for e in sched.sorted_entries()]


@pytest.fixture(scope="module")
def suites():
    """(JAX apps, JAX numpy-backed sneakpeeks, port apps, port sneakpeeks)."""
    j_apps, j_sneaks = japps.build_benchmark_suite(backend="numpy", seed=0)
    t_apps, t_sneaks = tapps.build_benchmark_suite(backend="numpy", seed=0, device="cpu")
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


def _warm_states(suites, policy, capacity, wids=None, workers=None):
    """A reference and a port state, each carrying one committed window
    (backlog and residency) scheduled by the policy's fast path."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, 90, "some", per_app=5, start_rid=500)
    js = JStreamingState(worker_ids=wids, memory_capacity_bytes=capacity)
    ts = StreamingState(worker_ids=wids, memory_capacity_bytes=capacity)
    jw = _pool(workers, JWorker) if workers else None
    tw = _pool(workers, Worker) if workers else None
    j_sched, _ = j_schedule_window(j_make_policy(policy), j_reqs, j_apps, 0.1, workers=jw,
                                   state=js)
    j_evaluate(j_sched, j_apps, 0.1, state=js)
    t_sched, _ = tsched.schedule_window(tsched.make_policy(policy), t_reqs, t_apps, 0.1,
                                        workers=tw, state=ts, device="cpu")
    t_evaluate(t_sched, t_apps, 0.1, state=ts, device="cpu")
    assert _sig(t_sched) == _sig(j_sched)
    return js, ts


# ------------------------------------------------------- one worker


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("capacity", CAPACITIES, ids=CAPACITY_IDS)
@pytest.mark.parametrize("theta", THETA_MODES)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_pipeline_matches_fast_and_scalar(suites, policy, theta, capacity, carried):
    """``pipeline=True`` on one worker: the reference's fast-path and
    scalar schedules, field by field, times bit-equal."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, THETA_MODES.index(theta), theta)
    now = 0.2 if carried else 0.1
    j_state = t_state = None
    if carried:
        j_state, t_state = _warm_states(suites, policy, capacity)
    elif capacity is not None:  # a fresh state that holds the capacity
        j_state = JStreamingState(memory_capacity_bytes=capacity)
        t_state = StreamingState(memory_capacity_bytes=capacity)
    want = j_make_policy(policy).schedule(j_reqs, j_apps, now, state=j_state)
    scalar = j_make_policy(policy, fastpath=False).schedule(j_reqs, j_apps, now, state=j_state)
    assert _sig(scalar) == _sig(want)
    got = tsched.make_policy(policy, pipeline=True).schedule(t_reqs, t_apps, now,
                                                             state=t_state, device="cpu")
    assert _sig(got) == _sig(want)
    direct = tpipe.pipeline_schedule(tsched.make_policy(policy), t_reqs, t_apps, now,
                                     state=t_state, device="cpu")
    assert _sig(direct) == _sig(want)
    assert got.chunk_stats is None


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_pipeline_long_window(suites, policy):
    """One window of 1,200 requests (per_app 400): the per-request scan
    runs 1,200 sequential steps, the grouped one over groups of up to
    ~400 members."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, 11, "some", per_app=400)
    want = j_make_policy(policy).schedule(j_reqs, j_apps, 0.1)
    got = tsched.make_policy(policy, pipeline=True).schedule(t_reqs, t_apps, 0.1, device="cpu")
    assert _sig(got) == _sig(want)
    if policy in ("LO-EDF", "SneakPeek"):
        want, _ = j_schedule_window(j_make_policy(policy), j_reqs, j_apps, 0.1,
                                    workers=_pool(POOLS[2], JWorker))
        got, _ = tsched.schedule_window(tsched.make_policy(policy, pipeline=True), t_reqs,
                                        t_apps, 0.1, workers=_pool(POOLS[2], Worker),
                                        device="cpu")
        assert _sig(got) == _sig(want)


def test_pipeline_backend_switch(suites):
    """"numpy" routes through the port's fast path, "auto" and "jax"
    through the scan: the same schedule."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, 4, "all")
    want = j_make_policy("LO-Priority").schedule(j_reqs, j_apps, 0.1)
    assert tpipe.get_pipeline_backend() == "auto"
    for backend in ("auto", "jax", "numpy"):
        pipe = tpipe.WindowPipeline(t_apps, policy=tsched.make_policy("LO-Priority"),
                                    backend=backend, device="cpu")
        assert pipe.resolved_backend() == ("numpy" if backend == "numpy" else "jax")
        assert _sig(pipe.schedule(t_reqs, 0.1)) == _sig(want)
    try:
        tpipe.set_pipeline_backend("numpy")
        got = tsched.make_policy("LO-Priority", pipeline=True).schedule(t_reqs, t_apps, 0.1,
                                                                         device="cpu")
        assert _sig(got) == _sig(want)
    finally:
        tpipe.set_pipeline_backend("auto")
    with pytest.raises(ValueError, match="unknown pipeline backend"):
        tpipe.set_pipeline_backend("xla")


def test_pipeline_run_ingests_once(suites):
    """``WindowPipeline.run``: ingest through the port's ``ingest_window``
    then schedule, as the reference's pipeline runs it."""
    j_apps, j_sneaks, t_apps, t_sneaks = suites
    j_reqs, t_reqs = _windows(suites, 5, "none")
    j_attach(j_reqs, j_apps, j_sneaks)
    want = j_make_policy("SneakPeek").schedule(j_reqs, j_apps, 0.1)
    pipe = tpipe.WindowPipeline(t_apps, t_sneaks, policy=tsched.make_policy("SneakPeek"),
                                device="cpu")
    assert _sig(pipe.run(t_reqs, 0.1)) == _sig(want)
    theta = [r.theta.copy() for r in t_reqs]
    pipe.ingest(t_reqs)  # evidence is drawn once per request
    assert all(np.array_equal(a, r.theta) for a, r in zip(theta, t_reqs))


# ------------------------------------------------------- worker pools


@pytest.mark.parametrize("theta", THETA_MODES)
@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_pipeline_pool_matches_reference(suites, policy, pool, theta):
    """The compiled Eq. 15 placement: the reference's fast and scalar
    placement, field by field."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, POOLS.index(pool), theta)
    want, _ = j_schedule_window(j_make_policy(policy), j_reqs, j_apps, 0.1,
                                workers=_pool(pool, JWorker))
    scalar, _ = j_schedule_window(j_make_policy(policy, fastpath=False), j_reqs, j_apps, 0.1,
                                  workers=_pool(pool, JWorker))
    assert _sig(scalar) == _sig(want)
    got, _ = tsched.schedule_window(tsched.make_policy(policy, pipeline=True), t_reqs, t_apps,
                                    0.1, workers=_pool(pool, Worker), device="cpu")
    assert _sig(got) == _sig(want)


@pytest.mark.parametrize("capacity", CAPACITIES, ids=CAPACITY_IDS)
@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_pipeline_pool_carried_state(suites, policy, pool, capacity):
    """Placement against a carried pool state (backlog, LRU residency under
    the capacity): the reference's fast and scalar placement."""
    j_apps, _, t_apps, _ = suites
    wids = [w for w, _, _ in pool]
    js, ts = _warm_states(suites, policy, capacity, wids=wids, workers=pool)
    j_reqs, t_reqs = _windows(suites, 40 + POOLS.index(pool), "some", shift=0.1)
    want, _ = j_schedule_window(j_make_policy(policy), j_reqs, j_apps, 0.2,
                                workers=_pool(pool, JWorker), state=js)
    scalar, _ = j_schedule_window(j_make_policy(policy, fastpath=False), j_reqs, j_apps, 0.2,
                                  workers=_pool(pool, JWorker), state=js)
    assert _sig(scalar) == _sig(want)
    got, _ = tsched.schedule_window(tsched.make_policy(policy, pipeline=True), t_reqs, t_apps,
                                    0.2, workers=_pool(pool, Worker), state=ts, device="cpu")
    assert _sig(got) == _sig(want)


@pytest.mark.parametrize("which", ["lat_scale", "worker_mask", "both"])
@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
def test_pipeline_lat_scale_and_worker_mask(suites, pool, which):
    """Drift scales multiply the scan's latency tables and its tie-break
    permutation; a worker mask removes workers before the tables are
    built."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, 7, "all")
    wids = [w for w, _, _ in pool]
    names = [m.name for app in t_apps.values() for m in app.models]
    scale = {(wid, name): 1.0 + 0.25 * ((k + i) % 3)
             for k, wid in enumerate(wids) for i, name in enumerate(names)}
    mask = set(wids[1:])
    kwargs = {"lat_scale": {"lat_scale": scale}, "worker_mask": {"worker_mask": mask},
              "both": {"lat_scale": scale, "worker_mask": mask}}[which]
    for policy in ("SneakPeek", "LO-EDF"):
        want, _ = j_schedule_window(j_make_policy(policy), j_reqs, j_apps, 0.1,
                                    workers=_pool(pool, JWorker), **kwargs)
        got, _ = tsched.schedule_window(tsched.make_policy(policy, pipeline=True), t_reqs,
                                        t_apps, 0.1, workers=_pool(pool, Worker),
                                        device="cpu", **kwargs)
        assert _sig(got) == _sig(want)
        if "worker_mask" in kwargs:
            assert {e.worker for e in got.entries} <= mask
    pipe = tpipe.WindowPipeline(t_apps, policy=tsched.make_policy("SneakPeek"), device="cpu")
    with pytest.raises(ValueError, match="multi-worker"):
        pipe.schedule(t_reqs, 0.1, lat_scale=scale)
    with pytest.raises(ValueError, match="excludes every worker"):
        pipe.schedule(t_reqs, 0.1, workers=_pool(pool, Worker), worker_mask=set())


def test_placement_pref_pads_like_reference():
    """``placement_pref(pad_to=)`` and ``PoolArrays.res_mode``: the
    reference's permutation, padded candidates last."""
    from repro.core.fastpath import placement_pref as j_pref

    names = ["b", "a", "c"]
    lat = np.array([0.02, 0.01, 0.02])
    speeds = np.array([1.0, 2.0])
    scale = np.array([[1.0, 2.0, 1.0], [0.5, 1.0, 1.0]])
    for pad_to in (None, 3, 5):
        for sc in (None, scale):
            np.testing.assert_array_equal(
                tfast.placement_pref(names, lat, speeds, [4, 9], pad_to=pad_to, scale=sc),
                j_pref(names, lat, speeds, [4, 9], pad_to=pad_to, scale=sc))


# ------------------------------------------------- the plain scan at the edges


def _scan_case(rng, n_groups, b_max, m_max, n_w, n_apps, case):
    """Inputs of one multi-worker scan (reference table layout), with the
    edge ``case``: "one-group", "m1", "one-valid", "ties", "lru-chain"."""
    gids = np.full((n_apps, m_max), -2, dtype=np.int64)
    valid = np.zeros((n_apps, m_max), dtype=bool)
    n_ids = n_apps * m_max
    for a in range(n_apps):
        m = m_max if case != "one-valid" else 1
        gids[a, :m] = rng.permutation(n_ids)[:m]
        valid[a, :m] = True
    # Quantized values: exact ties happen, and the sums stay exact.
    acc = np.round(rng.uniform(0.5, 1.0, (n_groups, b_max, m_max)) * 8) / 8
    lat = np.round(rng.uniform(0.01, 0.08, (n_groups, n_w, m_max)) * 64) / 64
    swap = np.round(rng.uniform(0.0, 0.1, (n_apps, n_w, m_max)) * 64) / 64
    if case == "ties":
        acc[:] = 0.75
        lat[:] = 1 / 32
        swap[:] = 1 / 16
    sizes = rng.integers(1, 6, n_apps * m_max).astype(np.float64) * 2**20
    counts = rng.integers(1, b_max + 1, n_groups)
    mask = (np.arange(b_max)[None, :] < counts[:, None]).astype(np.float64)
    deadlines = np.where(mask > 0, rng.uniform(0.05, 0.6, (n_groups, b_max)), 1.0)
    if case == "ties":
        deadlines[:] = 5.0
    pens = (rng.permutation(list(PENALTY_CODES))[:n_apps] if n_apps <= len(PENALTY_CODES)
            else rng.choice(list(PENALTY_CODES), n_apps))
    prefs = np.stack([rng.permutation(n_w * m_max) for _ in range(n_apps)])
    return {
        "acc": acc, "mask": mask, "deadlines": deadlines, "bsize": counts.astype(np.float64),
        "app_id": rng.integers(0, n_apps, n_groups), "lat": lat, "swap": swap, "gid": gids,
        "valid": valid, "pens": pens, "pref": prefs, "sizes": sizes,
        "cap": 6.0 * 2**20 if case == "lru-chain" else 0.0,
    }


def _ref_multiworker(c, res_mode, t0, res0):
    prog = jpipe._multiworker_program(res_mode)
    n_w = len(t0)
    with jax.enable_x64(True):
        out = prog(t0, res0 if res_mode == "lru" else res0[:, 0],
                   np.tile(c["sizes"], (n_w, 1)), np.float64(c["cap"]), c["acc"], c["mask"],
                   c["deadlines"], c["bsize"], c["app_id"], c["lat"], c["swap"], c["gid"],
                   c["valid"], np.array([J_PENALTY_ID[p] for p in c["pens"]]), c["pref"])
    return [np.asarray(x) for x in out]


def _port_scan(c, res_mode, t0, res0):
    tt = {k: torch.as_tensor(v) for k, v in c.items() if k != "pens" and k != "cap"}
    out = selection_scan(
        t0, res0, np.tile(c["sizes"], (len(t0), 1)), c["cap"], res_mode, tt["acc"], tt["mask"],
        tt["deadlines"], tt["bsize"], tt["lat"], tt["app_id"], tt["swap"], tt["gid"],
        tt["valid"], torch.tensor([PENALTY_CODES[p] for p in c["pens"]]), tt["pref"])
    return out.numpy()


@pytest.mark.parametrize("res_mode", ["slot1", "lru"])
@pytest.mark.parametrize("case,shape", [
    ("one-group", (1, 4, 3, 2, 1)), ("m1", (9, 3, 1, 2, 2)), ("one-valid", (8, 3, 4, 3, 2)),
    ("ties", (10, 2, 3, 3, 2)), ("lru-chain", (12, 3, 3, 2, 3)),
    ("many-ids", (30, 3, 8, 2, 12)),
], ids=["one-group", "m1", "one-valid", "ties", "lru-chain", "many-ids"])
def test_plain_scan_matches_reference_step_program(case, shape, res_mode):
    """The plain scan against the reference's compiled multi-worker step
    (src/repro/core/pipeline.py:646, under jax.enable_x64): workers,
    models, starts and latencies bit-equal."""
    rng = np.random.default_rng(len(case) * 7 + len(res_mode))
    n_groups, b_max, m_max, n_w, n_apps = shape
    c = _scan_case(rng, n_groups, b_max, m_max, n_w, n_apps, case)
    t0 = np.round(rng.uniform(0.1, 0.3, n_w) * 64) / 64
    n_ids = n_apps * m_max
    res0 = np.full((n_w, n_ids), -1, dtype=np.int64)
    for w in range(n_w):
        held = rng.permutation(n_ids)[: (1 if res_mode == "slot1" else 3)]
        res0[w, : len(held)] = held
    if res_mode == "slot1":
        res0 = res0[:, :1].copy()
    wsel, sel, starts, lats = _ref_multiworker(c, res_mode, t0, res0)
    got = _port_scan(c, res_mode, t0, res0)
    np.testing.assert_array_equal(got[0], wsel)
    np.testing.assert_array_equal(got[1], sel)
    np.testing.assert_array_equal(got[2], starts)
    np.testing.assert_array_equal(got[3], lats)
    if case == "one-valid":
        assert not got[1].any()


@pytest.mark.parametrize("res_mode", ["slot1", "lru"])
def test_plain_scan_matches_reference_grouped_program(res_mode):
    """The grouped program's tables through the port's ``_grouped_program``
    against the reference's (src/repro/core/pipeline.py:575)."""
    rng = np.random.default_rng(3)
    n_groups, b_max, m_max = 7, 5, 4
    c = _scan_case(rng, n_groups, b_max, m_max, 1, n_groups, "lru-chain")
    lat = c["lat"][:, 0]
    swap = np.round(rng.uniform(0.0, 0.1, (n_groups, m_max)) * 64) / 64
    gid = c["gid"][:n_groups]
    valid = c["valid"][:n_groups]
    valid[2, 2:] = False
    gid[2, 2:] = -2
    pens = rng.choice(list(PENALTY_CODES), n_groups)
    n_ids = n_groups * m_max
    sizes = np.tile(c["sizes"][:n_ids], (1, 1))
    res0 = np.full((1, n_ids), -1, dtype=np.int64)
    res0[0, :2] = [gid[0, 1], (gid[0, 1] + 1) % n_ids] if res_mode == "lru" else [gid[0, 1], -1]
    if res_mode == "slot1":
        res0 = res0[:, :1].copy()
    t0 = np.array([0.125])
    prog = jpipe._grouped_program(res_mode)
    with jax.enable_x64(True):
        want = prog(np.float64(t0[0]), res0[0] if res_mode == "lru" else np.int64(res0[0, 0]),
                    sizes[0], np.float64(c["cap"]), c["acc"], c["mask"], c["deadlines"],
                    c["bsize"], lat, swap, gid, valid,
                    np.array([J_PENALTY_ID[p] for p in pens]))
    want = [np.asarray(x) for x in want]
    tt = lambda x: torch.as_tensor(x)  # noqa: E731
    tabs = {"swap": tt(swap), "gid": tt(gid), "valid": tt(valid),
            "pen": torch.tensor([PENALTY_CODES[p] for p in pens]),
            "pref": torch.arange(m_max).expand(n_groups, m_max).contiguous()}
    got, stats = tpipe._grouped_program(
        res_mode, (t0, res0, sizes, c["cap"]), tt(c["acc"]), tt(c["mask"]), tt(c["deadlines"]),
        tt(c["bsize"]), tt(lat), torch.arange(n_groups), tabs)
    assert stats is None  # the sequential scan has no rounds
    for row, ref in zip(got[1:], want):
        np.testing.assert_array_equal(row, ref)
    assert not got[0].any()


def test_touch_residency_matches_host_rule():
    """``_touch_residency`` (the tensor form) against
    ``residency.touch_lru_array`` over a random load sequence with
    evictions."""
    from repro_torch.core.residency import touch_lru_array

    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 9, 12).astype(np.float64)
    res_np = np.full(12, -1, dtype=np.int64)
    res_t = torch.as_tensor(res_np)
    for gid in rng.integers(0, 12, 200):
        res_np, was_np = touch_lru_array(res_np, int(gid), sizes, 14.0)
        res_t, was_t = tpipe._touch_residency(res_t, int(gid), torch.as_tensor(sizes), 14.0)
        np.testing.assert_array_equal(res_t.numpy(), res_np)
        assert was_t == was_np


def test_scan_wrapper_refuses_inexact_sizes():
    """The LRU rule is exact only for integer byte counts below 2^53."""
    c = _scan_case(np.random.default_rng(1), 3, 2, 2, 1, 1, "lru-chain")
    tt = {k: torch.as_tensor(v) for k, v in c.items() if k != "pens" and k != "cap"}
    args = (tt["acc"], tt["mask"], tt["deadlines"], tt["bsize"], tt["lat"], tt["app_id"],
            tt["swap"], tt["gid"], tt["valid"], torch.tensor([3]), tt["pref"])
    res0 = np.full((1, 2), -1, dtype=np.int64)
    for sizes in (np.array([[1.5, 2.0]]), np.array([[2.0**53, 1.0]])):
        with pytest.raises(ValueError, match="integer byte counts"):
            selection_scan(np.array([0.0]), res0, sizes, 0.0, "lru", *args)


def test_scan_refuses_a_carry_beyond_shared_memory():
    """The scan keeps its carry in one block's shared memory (227 KiB on
    Hopper): a carry past it is refused on both routes under ROADMAP §3's
    label P7, and one just inside it runs."""
    from repro_torch.kernels.selection_scan import ops as scan_ops

    c = _scan_case(np.random.default_rng(1), 3, 2, 2, 1, 1, "lru-chain")
    tt = {k: torch.as_tensor(v) for k, v in c.items() if k != "pens" and k != "cap"}
    args = (tt["acc"], tt["mask"], tt["deadlines"], tt["bsize"], tt["lat"], tt["app_id"],
            tt["swap"], tt["gid"], tt["valid"], torch.tensor([3]), tt["pref"])
    fits = (scan_ops.MAX_SMEM_BYTES - scan_ops.smem_bytes(1, 0, 2)) // 8
    for n_slots, ok in ((fits, True), (fits + 1, False)):
        assert (scan_ops.smem_bytes(1, n_slots, 2) <= scan_ops.MAX_SMEM_BYTES) == ok
        res0 = np.full((1, n_slots), -1, dtype=np.int64)
        sizes = np.ones((1, n_slots))
        if ok:
            out = selection_scan(np.array([0.0]), res0, sizes, 1.0, "lru", *args)
            assert out.shape == (4, 3)
        else:
            with pytest.raises(ValueError, match="ROADMAP §3, P7"):
                selection_scan(np.array([0.0]), res0, sizes, 1.0, "lru", *args)


def _many_model_suites(n_variants):
    """Both packages' three applications, each with ``n_variants`` model
    variants (names unique across applications), so a window holds
    3 * n_variants model ids."""
    import dataclasses

    out = []
    for mod in (japps, tapps):
        apps = {}
        for i, spec in enumerate(mod.APP_SPECS.values()):
            base = spec.variants
            variants = tuple(
                (f"{spec.name}-{v}", *base[v % len(base)][1:3],
                 base[v % len(base)][3] * (1 + v / 64), base[v % len(base)][4],
                 base[v % len(base)][5] + v)
                for v in range(n_variants))
            apps[spec.name] = mod.make_application(
                dataclasses.replace(spec, variants=variants), seed=i)
        out.append(apps)
    return out


@pytest.mark.parametrize("workers", [None, POOLS[2]], ids=["one-worker", "pool"])
@pytest.mark.parametrize("policy", ["LO-EDF", "SneakPeek"])
def test_pipeline_window_with_many_model_ids(policy, workers):
    """A window over 75 model ids (three applications of 25 variants) and a
    capacity that evicts: the LRU carry spans every id, and the pipeline
    equals the reference's fast path."""
    j_apps, t_apps = _many_model_suites(25)
    reqs = []
    for mod, apps, attach, kw in ((japps, j_apps, j_attach, {}),
                                  (tapps, t_apps, t_attach, {"device": "cpu"})):
        specs = list(mod.APP_SPECS.values())
        sneaks = {s.name: mod.make_sneakpeek(s, backend="numpy", **kw) for s in specs}
        reqs.append(mod.make_requests(specs, per_app=8, mean_deadline_s=0.6,
                                      deadline_std_s=0.2, seed=4))
        attach(reqs[-1], apps, sneaks, **kw)
    capacity = 700 * 2**20
    wids = [w for w, _, _ in workers] if workers else None
    j_state = JStreamingState(worker_ids=wids, memory_capacity_bytes=capacity)
    t_state = StreamingState(worker_ids=wids, memory_capacity_bytes=capacity)
    want, _ = j_schedule_window(j_make_policy(policy), reqs[0], j_apps, 0.1,
                                workers=_pool(workers, JWorker) if workers else None,
                                state=j_state)
    got, _ = tsched.schedule_window(tsched.make_policy(policy, pipeline=True), reqs[1], t_apps,
                                    0.1, workers=_pool(workers, Worker) if workers else None,
                                    state=t_state, device="cpu")
    assert _sig(got) == _sig(want)
    assert len({e.model for e in got.entries}) > 1


# ------------------------------------------------------- precompute


@pytest.mark.parametrize("backend", ["numpy", "jax"])
@pytest.mark.parametrize("data_aware", [False, True], ids=["profiled", "sharpened"])
def test_precompute_windows_rows_equal_lazy(suites, data_aware, backend):
    """The stacked program's rows: bit-equal to the lazy per-window compute,
    for both backend values; priorities bit-equal to the reference's,
    Eq. 9 rows within 2 ulp of its lazy and stacked rows."""
    j_apps, _, t_apps, _ = suites
    pairs = [_windows(suites, 60 + k, THETA_MODES[k % 3], per_app=4 + 3 * k,
                      start_rid=100 * k, shift=0.1 * k) for k in range(4)]
    mode = "sharpened" if data_aware else "profiled"
    j_was = j_precompute_windows([(j, 0.1 * (k + 1)) for k, (j, _) in enumerate(pairs)],
                                 j_apps, data_aware=data_aware)
    t_was = tfast.precompute_windows([(t, 0.1 * (k + 1)) for k, (_, t) in enumerate(pairs)],
                                     t_apps, data_aware=data_aware, backend=backend,
                                     device="cpu")
    for k, ((j, t), jw, tw) in enumerate(zip(pairs, j_was, t_was)):
        lazy = tfast.WindowArrays(t, t_apps, 0.1 * (k + 1), device="cpu")
        assert np.array_equal(tw.priorities(data_aware), lazy.priorities(data_aware))
        assert np.array_equal(tw.priorities(data_aware), jw.priorities(data_aware))
        for name in tw.req_idx:
            assert torch.equal(tw.acc_matrix(name, mode), lazy.acc_matrix(name, mode))
            # Against the reference: its BLAS and torch's round a product
            # of a few rows differently in the last bit (the lazy rows
            # differ the same way; decisions are held bit-equal in the
            # simulation tests below), so within 2 ulp.
            j_lazy = jwindow.WindowArrays(j, j_apps, 0.1 * (k + 1))
            for ref in (j_lazy.acc_matrix(name, mode), jw.acc_matrix(name, mode)):
                np.testing.assert_allclose(tw.acc_matrix(name, mode).numpy(), ref,
                                           rtol=2 * np.finfo(np.float64).eps, atol=0)
    with pytest.raises(ValueError, match="unknown precompute backend"):
        tfast.precompute_windows([], t_apps, backend="xla", device="cpu")


# ------------------------------------------------------- the simulation


def _capture_schedules(monkeypatch, module):
    """Record every schedule ``Simulation.run`` commits through
    ``evaluate`` (the port's or the reference's simulator module)."""
    seen = []
    real = module.evaluate

    def spy(sched, *args, **kwargs):
        seen.append(_sig(sched))
        return real(sched, *args, **kwargs)

    monkeypatch.setattr(module, "evaluate", spy)
    return seen


def _trace(mod, seed, windows=6, per_app=5):
    reqs = []
    for w in range(windows):
        window = mod.make_requests(list(mod.APP_SPECS.values()), per_app=per_app,
                                   deadline_std_s=0.05, seed=seed + w, start_rid=100 * w)
        for r in window:
            r.arrival_s += 0.1 * w
            r.deadline_s += 0.1 * w
        reqs += window
    return reqs


@pytest.mark.parametrize("workers", [None, POOLS[2]], ids=["one-worker", "pool"])
@pytest.mark.parametrize("capacity", CAPACITIES, ids=CAPACITY_IDS)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_simulation_pipeline_matches_reference(suites, monkeypatch, policy, capacity, workers):
    """``Simulation(pipeline=True)``: every window's schedule, the log and
    the aggregates equal ``pipeline=False``'s and the reference's
    ``Simulation`` (its numpy fast path)."""
    from repro.core import simulator as jsim

    j_apps, j_sneaks, t_apps, t_sneaks = suites
    runs = {}
    for name, pipeline in (("ref", None), ("fast", False), ("pipe", True)):
        if name == "ref":
            seen = _capture_schedules(monkeypatch, jsim)
            sim = JSimulation(j_make_policy(policy), j_apps, sneakpeeks=j_sneaks,
                              short_circuit=True, seed=3, memory_capacity_bytes=capacity,
                              workers=_pool(workers, JWorker) if workers else None)
            agg = sim.run(_trace(japps, 21))
        else:
            seen = _capture_schedules(monkeypatch, tsim)
            sim = tsim.Simulation(tsched.make_policy(policy), t_apps, sneakpeeks=t_sneaks,
                                  short_circuit=True, seed=3, memory_capacity_bytes=capacity,
                                  workers=_pool(workers, Worker) if workers else None,
                                  pipeline=pipeline, device="cpu")
            agg = sim.run(_trace(tapps, 21))
        log = [{k: v for k, v in row.items() if k != "overhead_s"} for row in sim.log]
        runs[name] = (list(seen), log, agg)
        monkeypatch.undo()
    assert runs["pipe"] == runs["fast"] == runs["ref"]


@pytest.mark.parametrize("pipeline", [False, True], ids=["fast-path", "pipeline"])
@pytest.mark.parametrize("backend", ["numpy", "jax"])
@pytest.mark.parametrize("policy", ["LO-Priority", "Grouped", "SneakPeek"])
def test_prebatch_matches_reference(suites, monkeypatch, policy, backend, pipeline):
    """``Simulation(prebatch=4, prebatch_backend=...)``: the per-window
    decisions, log and aggregates of ``prebatch=0`` and of the
    reference's ``Simulation(prebatch=4)``."""
    from repro.core import simulator as jsim

    j_apps, j_sneaks, t_apps, t_sneaks = suites
    runs = {}
    for name, prebatch in (("ref", 4), ("lazy", 0), ("stacked", 4)):
        mod, sim_mod = (japps, jsim) if name == "ref" else (tapps, tsim)
        seen = _capture_schedules(monkeypatch, sim_mod)
        if name == "ref":
            sim = JSimulation(j_make_policy(policy), j_apps, sneakpeeks=j_sneaks,
                              short_circuit=True, seed=5, prebatch=prebatch)
        else:
            sim = tsim.Simulation(tsched.make_policy(policy), t_apps, sneakpeeks=t_sneaks,
                                  short_circuit=True, seed=5, prebatch=prebatch,
                                  prebatch_backend=backend, pipeline=pipeline, device="cpu")
        agg = sim.run(_trace(mod, 31, windows=7))
        log = [{k: v for k, v in row.items() if k != "overhead_s"} for row in sim.log]
        runs[name] = (list(seen), log, agg)
        monkeypatch.undo()
    assert runs["stacked"] == runs["lazy"] == runs["ref"]


# ------------------------------------------------------- the server


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("closed", [False, True], ids=["plain", "preempt+faults+health"])
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_edge_server_pipeline_matches_reference(policy, closed, overlap):
    """``EdgeServer(pipeline=True)`` over SimulatedBackend lanes (three
    workers, one twice as fast, a residency budget): the reference
    ``EdgeServer()``'s decisions, per-request records, counters and fired
    faults, synchronous and overlapped."""
    want = closed_loop_reference(policy, closed, closed, overlap)
    got = _sim_serve(T_PKG, policy, closed, closed, overlap, pipeline=True)
    assert got[4]._pipeline is not None
    assert got[:4] == want


def test_edge_server_keeps_one_pipeline(monkeypatch):
    """One persistent ``WindowPipeline`` schedules every window."""
    built = []
    real = tpipe.WindowPipeline.__init__

    def spy(self, *args, **kwargs):
        built.append(self)
        real(self, *args, **kwargs)

    monkeypatch.setattr(tpipe.WindowPipeline, "__init__", spy)
    decisions, _, stats, _, srv = _sim_serve(T_PKG, "SneakPeek", pipeline=True)
    assert len(built) == 1 and srv._pipeline is built[0]
    assert stats["windows"] > 1 and decisions


# ------------------------------------------------------- chunked selection

CHUNKS = [1, 3, 16, 10_000]  # the last > any window here: one round speculates all


@pytest.fixture
def ref_x64(monkeypatch):
    """The reference's ``WindowPipeline`` with its x64 switch repaired for
    this test (``jax.enable_x64``; C1 breaks ``jax.experimental``'s): its
    compiled programs, the chunked ones included, run as written."""
    monkeypatch.setattr(jpipe.WindowPipeline, "_enable_x64", lambda self: jax.enable_x64(True))


def _port_spec(c, res_mode, t0, res0, chunk, fixed=None):
    tt = {k: torch.as_tensor(v) for k, v in c.items() if k != "pens" and k != "cap"}
    out = spec_scan(
        t0, res0, np.tile(c["sizes"], (len(t0), 1)), c["cap"], res_mode, tt["acc"], tt["mask"],
        tt["deadlines"], tt["bsize"], tt["lat"], tt["app_id"], tt["swap"], tt["gid"],
        tt["valid"], torch.tensor([PENALTY_CODES[p] for p in c["pens"]]), tt["pref"], fixed,
        chunk=chunk)
    return out.numpy()


@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("res_mode", ["slot1", "lru"])
@pytest.mark.parametrize("case,shape", [
    ("one-group", (1, 4, 3, 2, 1)), ("m1", (9, 3, 1, 2, 2)), ("ties", (10, 2, 3, 3, 2)),
    ("lru-chain", (12, 3, 3, 2, 3)), ("many-ids", (30, 3, 8, 2, 12)),
], ids=["one-group", "m1", "ties", "lru-chain", "many-ids"])
def test_plain_chunked_scan_matches_reference_program(case, shape, res_mode, chunk):
    """The port's plain chunked scan against the reference's chunked
    multi-worker program (``_multiworker_program(res_mode, chunk)``, its
    ``_spec_select_mw``, under jax.enable_x64): workers, models, starts,
    latencies, rounds and conflicts bit-equal, and the rows equal the
    sequential scan's."""
    rng = np.random.default_rng(len(case) * 11 + len(res_mode))
    n_groups, b_max, m_max, n_w, n_apps = shape
    c = _scan_case(rng, n_groups, b_max, m_max, n_w, n_apps, case)
    t0 = np.round(rng.uniform(0.1, 0.3, n_w) * 64) / 64
    n_ids = n_apps * m_max
    res0 = np.full((n_w, n_ids), -1, dtype=np.int64)
    for w in range(n_w):
        held = rng.permutation(n_ids)[: (1 if res_mode == "slot1" else 3)]
        res0[w, : len(held)] = held
    if res_mode == "slot1":
        res0 = res0[:, :1].copy()
    prog = jpipe._multiworker_program(res_mode, chunk)
    with jax.enable_x64(True):
        want = prog(t0, res0 if res_mode == "lru" else res0[:, 0],
                    np.tile(c["sizes"], (n_w, 1)), np.float64(c["cap"]), c["acc"], c["mask"],
                    c["deadlines"], c["bsize"], c["app_id"], c["lat"], c["swap"], c["gid"],
                    c["valid"], np.array([J_PENALTY_ID[p] for p in c["pens"]]), c["pref"])
    want = [np.asarray(x) for x in want]
    got = _port_spec(c, res_mode, t0, res0, chunk)
    for row, ref in zip(got[:, :-1], want[:4]):
        np.testing.assert_array_equal(row, ref)
    np.testing.assert_array_equal(got[:2, -1], want[4])
    np.testing.assert_array_equal(got[:, :-1], _port_scan(c, res_mode, t0, res0))
    assert got[0, -1] >= -(-n_groups // chunk)  # chunk_layout's least rounds


@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("res_mode", ["slot1", "lru"])
def test_plain_chunked_scan_matches_reference_grouped_program(res_mode, chunk):
    """The port's ``_grouped_program(..., chunk)`` against the reference's
    ``_grouped_program(res_mode, chunk)`` (its ``_spec_select``):
    decisions, starts, latencies, rounds and conflicts bit-equal."""
    rng = np.random.default_rng(5)
    n_groups, b_max, m_max = 9, 5, 4
    c = _scan_case(rng, n_groups, b_max, m_max, 1, n_groups, "lru-chain")
    lat = c["lat"][:, 0]
    swap = np.round(rng.uniform(0.0, 0.1, (n_groups, m_max)) * 64) / 64
    gid, valid = c["gid"][:n_groups], c["valid"][:n_groups]
    valid[2, 2:] = False
    gid[2, 2:] = -2
    pens = rng.choice(list(PENALTY_CODES), n_groups)
    n_ids = n_groups * m_max
    sizes = np.tile(c["sizes"][:n_ids], (1, 1))
    res0 = np.full((1, n_ids), -1, dtype=np.int64)
    res0[0, :2] = [gid[0, 1], (gid[0, 1] + 1) % n_ids] if res_mode == "lru" else [gid[0, 1], -1]
    if res_mode == "slot1":
        res0 = res0[:, :1].copy()
    t0 = np.array([0.125])
    prog = jpipe._grouped_program(res_mode, chunk)
    with jax.enable_x64(True):
        want = prog(np.float64(t0[0]), res0[0] if res_mode == "lru" else np.int64(res0[0, 0]),
                    sizes[0], np.float64(c["cap"]), c["acc"], c["mask"], c["deadlines"],
                    c["bsize"], lat, swap, gid, valid,
                    np.array([J_PENALTY_ID[p] for p in pens]))
    want = [np.asarray(x) for x in want]
    tt = lambda x: torch.as_tensor(x)  # noqa: E731
    tabs = {"swap": tt(swap), "gid": tt(gid), "valid": tt(valid),
            "pen": torch.tensor([PENALTY_CODES[p] for p in pens]),
            "pref": torch.arange(m_max).expand(n_groups, m_max).contiguous()}
    rows, stats = tpipe._grouped_program(
        res_mode, (t0, res0, sizes, c["cap"]), tt(c["acc"]), tt(c["mask"]), tt(c["deadlines"]),
        tt(c["bsize"]), tt(lat), torch.arange(n_groups), tabs, chunk)
    for row, ref in zip(rows[1:], want[:3]):
        np.testing.assert_array_equal(row, ref)
    np.testing.assert_array_equal(stats, want[3])


def test_plain_chunked_scan_fixed_choices():
    """MaxAcc's carry-free choices (``fixed_sel``): the chunked scan threads
    the carry only, never conflicts, and equals the sequential scan."""
    rng = np.random.default_rng(8)
    c = _scan_case(rng, 13, 1, 4, 1, 3, "lru-chain")
    fixed = torch.as_tensor(rng.integers(0, 4, 13))
    t0, res0 = np.array([0.25]), np.array([[-1] * 12])
    tt = {k: torch.as_tensor(v) for k, v in c.items() if k != "pens" and k != "cap"}
    want = selection_scan(
        t0, res0, np.tile(c["sizes"], (1, 1)), c["cap"], "lru", tt["acc"], tt["mask"],
        tt["deadlines"], tt["bsize"], tt["lat"], tt["app_id"], tt["swap"], tt["gid"],
        tt["valid"], torch.tensor([PENALTY_CODES[p] for p in c["pens"]]), tt["pref"], fixed)
    for chunk in (1, 4, 13, 40):
        got = _port_spec(c, "lru", t0, res0, chunk, fixed)
        np.testing.assert_array_equal(got[:, :-1], want.numpy())
        assert got[0, -1] == -(-13 // chunk) and got[1, -1] == 0


def test_chunked_scan_refuses_a_carry_beyond_shared_memory():
    """P7 with chunks: the chunked scan keeps each position's pre-state
    slots in device memory, so the carry's ids do not multiply by the
    chunk; a 600-id LRU carry runs at chunks 4 and 64, and a carry past
    one block's 227 KiB is refused on both routes at any chunk, naming
    it."""
    from repro_torch.kernels.selection_scan.ops import MAX_SMEM_BYTES, smem_bytes

    n_ids = 600
    grow = smem_bytes(1, n_ids, 6, chunk=64) - smem_bytes(1, n_ids, 6, chunk=4)
    assert grow == smem_bytes(1, 0, 6, chunk=64) - smem_bytes(1, 0, 6, chunk=4)
    assert smem_bytes(1, n_ids, 6, chunk=64) <= MAX_SMEM_BYTES
    rng = np.random.default_rng(2)
    c = _scan_case(rng, 70, 2, 6, 1, 1, "lru-chain")  # 70 steps: chunk 64 stays 64
    tt = {k: torch.as_tensor(v) for k, v in c.items() if k != "pens" and k != "cap"}
    tabs = (tt["acc"], tt["mask"], tt["deadlines"], tt["bsize"], tt["lat"], tt["app_id"],
            tt["swap"], tt["gid"], tt["valid"],
            torch.tensor([PENALTY_CODES[p] for p in c["pens"]]), tt["pref"])

    def run(n, chunk):
        return spec_scan(np.zeros(1), np.full((1, n), -1), np.ones((1, n)), 10.0, "lru",
                         *tabs, chunk=chunk)

    seq = selection_scan(np.zeros(1), np.full((1, n_ids), -1), np.ones((1, n_ids)), 10.0,
                         "lru", *tabs)
    for chunk in (4, 64):
        np.testing.assert_array_equal(run(n_ids, chunk)[:, :-1].numpy(), seq.numpy())
    too_many = MAX_SMEM_BYTES // 8  # (W·K + W)·8 bytes past the block's share
    assert smem_bytes(1, too_many, 6, chunk=4) > MAX_SMEM_BYTES
    for chunk in (1, 64):
        with pytest.raises(ValueError,
                           match=r"K=%d model ids.*C=%d speculated positions.*P7" % (too_many,
                                                                                     chunk)):
            run(too_many, chunk)
    with pytest.raises(ValueError, match="chunk must be positive"):
        run(n_ids, 0)


@pytest.mark.parametrize("chunk", [3, 16])
@pytest.mark.parametrize("capacity", CAPACITIES, ids=CAPACITY_IDS)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_chunked_pipeline_matches_reference(suites, ref_x64, policy, capacity, chunk):
    """The reference's chunked ``WindowPipeline`` (its compiled per-request
    and grouped programs with ``chunk``) against the port's on one worker,
    from a carried state (the evicting capacity gives the LRU carry):
    schedules field by field and ``Schedule.chunk_stats``."""
    j_apps, _, t_apps, _ = suites
    j_state, t_state = _warm_states(suites, policy, capacity)
    j_reqs, t_reqs = _windows(suites, 70 + chunk, "some", per_app=12, shift=0.1)
    want = jpipe.WindowPipeline(j_apps, policy=j_make_policy(policy), chunk=chunk,
                                backend="jax").schedule(j_reqs, 0.2, state=j_state)
    got = tpipe.WindowPipeline(t_apps, policy=tsched.make_policy(policy), chunk=chunk,
                               device="cpu").schedule(t_reqs, 0.2, state=t_state)
    assert _sig(got) == _sig(want)
    assert got.chunk_stats == want.chunk_stats
    if policy != "Grouped":  # Grouped's three groups take the brute-force branch
        assert got.chunk_stats["chunk"] == chunk and got.chunk_stats["rounds"] >= 1


@pytest.mark.parametrize("shards", [2, 3, 4, 8])
@pytest.mark.parametrize("policy", ["LO-EDF", "SneakPeek"])
def test_sharded_batched_rounds_match_reference(suites, ref_x64, policy, shards):
    """The sharded rounds with the position on the device, enqueued a
    batch at a time and read back once a batch, at ``chunk=3`` (conflicts
    cut batches short): the reference's chunked ``WindowPipeline``'s
    decisions and ``chunk_stats``, ``last_shard_stats`` its rounds and
    conflicts, and more than one read-back (the windows are seeded so that
    a conflict before a round's last position cuts a batch short)."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, {"LO-EDF": 63, "SneakPeek": 65}[policy], "all",
                              per_app=12, shift=0.1)
    want = jpipe.WindowPipeline(j_apps, policy=j_make_policy(policy), chunk=3,
                                backend="jax").schedule(j_reqs, 0.2)
    prev = tshard.force_shard_devices(8)
    try:
        pipe = tshard.ShardedWindowPipeline(t_apps, policy=tsched.make_policy(policy), chunk=3,
                                            shard=shards, device="cpu")
        got = pipe.schedule(t_reqs, 0.2)
    finally:
        tshard.force_shard_devices(prev)
    assert _sig(got) == _sig(want)
    assert got.chunk_stats == want.chunk_stats
    stats = want.chunk_stats
    assert pipe.last_shard_stats == {"num_shards": shards, "rounds": stats["rounds"],
                                     "conflicts": stats["conflicts"]}
    assert stats["conflicts"] > 0 and pipe.last_read_backs > 1


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("policy", ["LO-EDF", "SneakPeek"])
def test_chunked_pool_matches_reference(suites, ref_x64, policy, pool):
    """The reference's chunked Eq. 15 placement (``_spec_select_mw``) with
    drift scales and a worker mask against the port's: schedules and
    ``chunk_stats``."""
    j_apps, _, t_apps, _ = suites
    j_reqs, t_reqs = _windows(suites, 80 + POOLS.index(pool), "all")
    wids = [w for w, _, _ in pool]
    names = [m.name for app in t_apps.values() for m in app.models]
    scale = {(wid, name): 1.0 + 0.25 * ((k + i) % 3)
             for k, wid in enumerate(wids) for i, name in enumerate(names)}
    for kwargs in ({}, {"lat_scale": scale, "worker_mask": set(wids[1:])}):
        want = jpipe.WindowPipeline(j_apps, policy=j_make_policy(policy), backend="jax",
                                    workers=_pool(pool, JWorker), chunk=8).schedule(
            j_reqs, 0.1, **kwargs)
        got = tpipe.WindowPipeline(t_apps, policy=tsched.make_policy(policy), device="cpu",
                                   workers=_pool(pool, Worker), chunk=8).schedule(
            t_reqs, 0.1, **kwargs)
        assert _sig(got) == _sig(want)
        assert got.chunk_stats == want.chunk_stats


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("capacity", CAPACITIES, ids=CAPACITY_IDS)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_chunked_equals_sequential(suites, policy, capacity, carried):
    """On one worker, every chunk size (1, 3, 16, larger than the window)
    gives ``chunk=0``'s schedule, slot1 and LRU, fresh and carried; the
    stats count the window's decisions."""
    _, _, t_apps, _ = suites
    _, t_reqs = _windows(suites, 90 + POLICY_NAMES.index(policy), "some", per_app=10)
    t_state = None
    if carried:
        _, t_state = _warm_states(suites, policy, capacity)
    elif capacity is not None:
        t_state = StreamingState(memory_capacity_bytes=capacity)
    now = 0.2 if carried else 0.1
    want = tsched.make_policy(policy, pipeline=True).schedule(t_reqs, t_apps, now,
                                                              state=t_state, device="cpu")
    assert want.chunk_stats is None
    for chunk in CHUNKS:
        got = tsched.make_policy(policy, pipeline=True, chunk=chunk).schedule(
            t_reqs, t_apps, now, state=t_state, device="cpu")
        assert _sig(got) == _sig(want)
        stats = got.chunk_stats
        if stats is None:  # the brute-force branch runs no scan
            assert policy == "Grouped"
            continue
        least, _ = tfast.chunk_layout(stats["decisions"], chunk)
        assert stats["rounds"] >= least and stats["conflicts"] <= stats["rounds"]
        assert stats["conflict_rate"] == stats["conflicts"] / stats["rounds"]


@pytest.mark.parametrize("pool", POOLS, ids=POOL_IDS)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_chunked_pool_equals_sequential(suites, policy, pool):
    """The four pools, with drift scales and a worker mask, from a carried
    LRU state: every chunk size places as ``chunk=0``."""
    _, _, t_apps, _ = suites
    wids = [w for w, _, _ in pool]
    _, ts = _warm_states(suites, policy, CAPACITIES[1], wids=wids, workers=pool)
    _, t_reqs = _windows(suites, 50 + POOLS.index(pool), "some", shift=0.1)
    names = [m.name for app in t_apps.values() for m in app.models]
    scale = {(wid, name): 1.0 + 0.25 * ((k + i) % 3)
             for k, wid in enumerate(wids) for i, name in enumerate(names)}
    for kwargs in ({}, {"lat_scale": scale}, {"worker_mask": set(wids[1:])}):
        want, _ = tsched.schedule_window(tsched.make_policy(policy, pipeline=True), t_reqs,
                                         t_apps, 0.2, workers=_pool(pool, Worker), state=ts,
                                         device="cpu", **kwargs)
        for chunk in CHUNKS:
            got, _ = tsched.schedule_window(
                tsched.make_policy(policy, pipeline=True, chunk=chunk), t_reqs, t_apps, 0.2,
                workers=_pool(pool, Worker), state=ts, device="cpu", **kwargs)
            assert _sig(got) == _sig(want)
            assert got.chunk_stats["decisions"] == len({e.batch_id for e in got.entries})


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_simulation_and_server_chunked(suites, monkeypatch, policy):
    """``Simulation(pipeline=True, chunk=16)`` commits ``chunk=0``'s
    schedules window by window, and ``EdgeServer(pipeline=True,
    chunk=16)`` records what the reference's ``EdgeServer()`` records."""
    _, _, t_apps, t_sneaks = suites
    runs = []
    for chunk in (0, 16):
        seen = _capture_schedules(monkeypatch, tsim)
        sim = tsim.Simulation(tsched.make_policy(policy), t_apps, sneakpeeks=t_sneaks,
                              short_circuit=True, seed=3, memory_capacity_bytes=CAPACITIES[1],
                              pipeline=True, chunk=chunk, device="cpu")
        agg = sim.run(_trace(tapps, 41))
        log = [{k: v for k, v in row.items() if k != "overhead_s"} for row in sim.log]
        runs.append((list(seen), log, agg))
        monkeypatch.undo()
    assert runs[0] == runs[1]
    assert sim._pipeline.chunk == 16
    want = closed_loop_reference(policy, True, True, False)
    got = _sim_serve(T_PKG, policy, True, True, False, pipeline=True, chunk=16)
    assert got[4]._pipeline.chunk == 16
    assert got[:4] == want


# ------------------------------------------------------- what still raises


def test_chunk_and_shard_still_raise(suites):
    """``chunk`` runs on every entry point (item 5 is ported), and so does
    sharding (item 11, ``core.shard``): each entry point that refused it
    now gives the unsharded schedule; a negative chunk is refused."""
    from repro_torch.core import shard as tshard

    _, _, t_apps, _ = suites
    _, t_reqs = _windows(suites, 0, "all")
    policy = tsched.make_policy("LO-EDF")
    assert tsched.make_policy("LO-EDF", pipeline=True, chunk=8).chunk == 8
    assert tpipe.WindowPipeline(t_apps, policy=policy, chunk=8, device="cpu").chunk == 8
    got = tpipe.pipeline_schedule(policy, t_reqs, t_apps, 0.1, chunk=8, device="cpu")
    assert got.chunk_stats["chunk"] == 8 and got.chunk_stats["decisions"] == len(t_reqs)
    sim = tsim.Simulation(policy, t_apps, pipeline=True, chunk=8, device="cpu")
    assert sim._pipeline.chunk == 8
    assert not hasattr(tsched, "NOT_PORTED")  # nothing of the scheduler is left to port
    want = _sig(tpipe.pipeline_schedule(policy, t_reqs, t_apps, 0.1, device="cpu"))
    prev = tshard.force_shard_devices(2)
    try:
        sharded = tsched.make_policy("LO-EDF", shard=True)
        assert sharded.shard is True
        assert _sig(sharded.schedule(t_reqs, t_apps, 0.1, device="cpu")) == want
        assert _sig(tpipe.pipeline_schedule(policy, t_reqs, t_apps, 0.1, shard=2,
                                            device="cpu")) == want
    finally:
        tshard.force_shard_devices(prev)
    sim = tsim.Simulation(policy, t_apps, shard=True, device="cpu")
    assert isinstance(sim._pipeline, tshard.ShardedWindowPipeline)
    assert sim._pipeline.num_shards() == 1  # one CPU: shard=True delegates
    with pytest.raises(ValueError, match="chunk must be >= 0"):
        tpipe.WindowPipeline(t_apps, policy=policy, chunk=-1, device="cpu")
    # The off values of the reference's fields are accepted.
    assert tsched.make_policy("LO-EDF", chunk=0, shard=False).pipeline is False
    assert tpipe.WindowPipeline(t_apps, policy=policy, chunk=0, device="cpu").chunk == 0


def test_pipeline_needs_cuda_unless_cpu_is_named(suites):
    """No silent fallback: a pipeline built without ``device="cpu"`` on a
    host without CUDA raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, _, t_apps, _ = suites
    _, t_reqs = _windows(suites, 0, "all")
    policy = tsched.make_policy("SneakPeek", pipeline=True)
    for call in (
        lambda: tpipe.WindowPipeline(t_apps, policy=policy),
        lambda: tpipe.pipeline_schedule(policy, t_reqs, t_apps, 0.1),
        lambda: policy.schedule(t_reqs, t_apps, 0.1),
        lambda: tsim.Simulation(policy, t_apps, pipeline=True),
        lambda: tfast.precompute_windows([(t_reqs, 0.1)], t_apps),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
