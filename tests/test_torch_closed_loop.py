"""The port's closed-loop serving against the JAX package's.

On the CPU (``device="cpu"``), from the same seeds, held against
``repro``:

* ``FaultInjector.poll`` (deterministic specs with counts, seeded rates)
  and ``FaultPlan``'s validation;
* ``HealthTracker`` states, drift scales and control signatures after
  the same ``observe`` / ``record_failure`` / ``close_window`` sequence;
* ``StreamingState.preempt`` and ``withdraw`` (tail and mid-queue)
  rollbacks, dispatch marks, the backlog's array encoding and its
  round trip through ``from_arrays``;
* ``evaluate(latency_scale=...)``, bit for bit;
* ``ExecutorPool.execute_supervised`` (crash cascades, errors of a batch,
  dispatch gating, lane deadlines);
* ``EdgeServer(preempt=, faults=, health=, overlap=)`` over
  ``SimulatedBackend`` lanes, for the five policies, serial and thread
  lanes and one process-lane case: the same decisions, per-request
  records, counters and fired faults; ``overlap=True`` decides as
  ``overlap=False``;
* ``preempt=True`` on reduced mamba2-130m through ``ProfiledBackend``.

The reference's compiled Eq. 15 pipeline does not run on the installed
JAX (ROADMAP C1), so quarantine masking and drift scales are held
against its numpy fast path and scalar loop instead.  Deterministic fault
specs pin their ``worker``: thread lanes poll in any order.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import POLICY_NAMES
from repro.core import Application as JApplication
from repro.core import ModelProfile as JModelProfile
from repro.core import Request as JRequest
from repro.core import Schedule as JSchedule
from repro.core import ScheduleEntry as JEntry
from repro.core import StreamingState as JStreamingState
from repro.core import Worker as JWorker
from repro.core import evaluate as j_evaluate
from repro.core import make_policy as j_make_policy
from repro.core import multiworker_schedule as j_multiworker
from repro.core.fastpath import fast_multiworker_schedule as j_fast_multiworker
from repro.core.health import HealthTracker as JHealthTracker
from repro.serving import EdgeServer as JEdgeServer
from repro.serving import ExecutorPool as JExecutorPool
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import FaultSpec as JFaultSpec
from repro.serving import SimulatedBackend as JSimulatedBackend
from repro_torch.core import scheduler as tsched
from repro_torch.core.accuracy import ModelProfile
from repro_torch.core.evaluation import evaluate as t_evaluate
from repro_torch.core.health import DEGRADED, HEALTHY, QUARANTINED, HealthTracker
from repro_torch.core.multiworker import Worker
from repro_torch.core.multiworker import multiworker_schedule as t_multiworker
from repro_torch.core.streaming import StreamingState
from repro_torch.core.types import Application, Request, Schedule, ScheduleEntry
from repro_torch.serving.backends import SimulatedBackend
from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.serving.runtime import ExecutorPool, PendingExecution
from repro_torch.serving.server import EdgeServer
from test_torch_serving import J_FAMILIES, _executors

# (EdgeServer, SimulatedBackend, ModelProfile, Application, Request, Worker,
#  make_policy, FaultPlan, FaultSpec, HealthTracker, ExecutorPool,
#  server keywords) of each package.
J = (JEdgeServer, JSimulatedBackend, JModelProfile, JApplication, JRequest, JWorker,
     j_make_policy, JFaultPlan, JFaultSpec, JHealthTracker, JExecutorPool, {})
T = (EdgeServer, SimulatedBackend, ModelProfile, Application, Request, Worker,
     tsched.make_policy, FaultPlan, FaultSpec, HealthTracker, ExecutorPool,
     {"device": "cpu"})


def _mods(pkg):
    names = ("server", "backend", "profile", "app", "request", "worker", "policy", "plan",
             "spec", "tracker", "pool", "extra")
    return dict(zip(names, pkg))


def _decisions(outs):
    return [(e.request.rid, e.model, e.worker, e.order, e.batch_id)
            for o in outs for e in o["schedule"].sorted_entries()]


COUNTERS = ("windows", "requests", "violations", "mean_utility", "swaps", "preempted",
            "dropped", "failed_batches", "retries", "dropped_after_retry", "fallbacks",
            "quarantined_workers", "realized_over_profiled", "worker_busy_s", "span_s",
            "worker_swaps", "pool_busy_s", "profile_provenance")


# ------------------------------------------------------------ fault plans


def test_fault_plan_validation_matches_reference():
    for cls, spec in ((JFaultPlan, JFaultSpec), (FaultPlan, FaultSpec)):
        with pytest.raises(ValueError, match="unknown fault kind"):
            spec(kind="meltdown")
        with pytest.raises(ValueError, match="unknown fault kind"):
            cls(rates={"meltdown": 0.5})
        with pytest.raises(ValueError, match="outside"):
            cls(rates={"crash": 1.5})
        with pytest.raises(ValueError, match="sum past"):
            cls(rates={"crash": 0.9, "transient": 0.3})
    assert FaultPlan(rates={"transient": 0.1, "crash": 0.2}).rates == \
        JFaultPlan(rates={"transient": 0.1, "crash": 0.2}).rates


PLANS = {
    "pinned": dict(specs=[("crash", 1, 0, 0, 0.0, 1), ("transient", None, 1, None, 0.0, 2),
                          ("hang", 2, 2, 1, 0.5, None)]),
    "wildcards": dict(specs=[("swap_fail", None, None, 3, 0.0, None),
                             ("transient", 0, None, None, 0.0, 3)]),
    "rates": dict(rates={"transient": 0.15, "crash": 0.05, "hang": 0.1}, seed=11,
                  hang_delay_s=0.2),
    "specs-and-rates": dict(specs=[("crash", 3, 1, 0, 0.0, 1)],
                            rates={"transient": 0.6, "swap_fail": 0.4}, seed=3),
}


def _plan(pkg, kwargs):
    m = _mods(pkg)
    kw = dict(kwargs)
    kw["specs"] = tuple(m["spec"](kind, window=w, worker=k, batch=b, delay_s=d, count=c)
                        for kind, w, k, b, d, c in kw.get("specs", ()))
    return m["plan"](**kw)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_injector_polls_like_reference(name):
    """Every (window, worker, batch) of a grid, polled in the same order:
    the same fault (kind, address, delay), fire counts and log."""
    jinj, tinj = JFaultInjector(_plan(J, PLANS[name])), FaultInjector(_plan(T, PLANS[name]))
    rng = np.random.default_rng(len(name))
    for window in range(5):
        for worker in range(3):
            for batch in range(4):
                rids = tuple(int(r) for r in rng.integers(0, 100, rng.integers(1, 4)))
                jf = jinj.poll(window, worker, batch, rids)
                tf = tinj.poll(window, worker, batch, rids)
                assert (tf is None) == (jf is None)
                if tf is not None:
                    assert (tf.kind, tf.window, tf.worker, tf.batch, tf.delay_s, tf.count) == \
                        (jf.kind, jf.window, jf.worker, jf.batch, jf.delay_s, jf.count)
    assert tinj.log == jinj.log and len(tinj.log) > 0
    for kind in (None, "crash", "transient", "swap_fail", "hang"):
        assert tinj.fired(kind) == jinj.fired(kind)


# ------------------------------------------------------------ health


@pytest.mark.parametrize("seed,overrides", [
    (0, {}), (1, {}), (2, {"straggler_ratio": 1.5, "cooldown_windows": 1}),
    (3, {"degrade_after": 2, "quarantine_after": 2, "ewma_beta": 0.5}),
    (4, {"quantum": 0.05, "min_scale": 0.5, "max_scale": 2.0}),
])
def test_health_tracker_matches_reference(seed, overrides):
    """The same random sequence of observations, failures and window
    closes: equal worker records, drift scales (quantized, bit for bit),
    masks, control signatures and ratio snapshots after every step."""
    rng = np.random.default_rng(seed)
    wids = [0, 1, 3]
    workers_t = [Worker(w) for w in wids]
    workers_j = [JWorker(w) for w in wids]
    jt, tt = JHealthTracker(wids, **overrides), HealthTracker(wids, **overrides)
    models = ["a", "b"]
    for _ in range(120):
        event = rng.choice(["observe", "observe", "observe", "fail", "close"])
        wid = int(rng.choice(wids))
        if event == "observe":
            model = str(rng.choice(models))
            committed = float(rng.choice([0.0, rng.uniform(0.01, 0.2)]))
            realized = float(committed * rng.uniform(0.2, 6.0) if committed else rng.uniform(0, 1))
            jt.observe(wid, model, realized, committed)
            tt.observe(wid, model, realized, committed)
        elif event == "fail":
            kind = str(rng.choice(["crash", "transient", "swap_fail", "timeout", "error"]))
            jt.record_failure(wid, kind)
            tt.record_failure(wid, kind)
        else:
            assert tt.close_window() == jt.close_window()
        assert {w: dataclasses.asdict(h) for w, h in tt._health.items()} == \
            {w: dataclasses.asdict(h) for w, h in jt._health.items()}
        assert tt.latency_scale() == jt.latency_scale()
        assert tt.control_signature(workers_t) == jt.control_signature(workers_j)
        assert tt.active_wids(workers_t) == jt.active_wids(workers_j)
        assert tt.quarantined() == jt.quarantined()
        assert tt.ratio_snapshot() == jt.ratio_snapshot()
        jf, tf = jt.scale_fn(), tt.scale_fn()
        assert (jf is None) == (tf is None)
        if tf is not None:
            for w in wids:
                for m in models:
                    assert tf(w, m) == jf(w, m)
    assert {tt.state_of(w) for w in wids} <= {HEALTHY, DEGRADED, QUARANTINED}


def test_health_tracker_state_machine():
    """healthy -> degraded -> quarantined -> (cooldown) -> degraded ->
    healthy; an all-quarantined pool stays schedulable."""
    t = HealthTracker([0, 1], degrade_after=1, quarantine_after=3, cooldown_windows=2)
    t.record_failure(0)
    assert t.state_of(0) == DEGRADED
    t.record_failure(0)
    t.record_failure(0)
    assert t.state_of(0) == QUARANTINED and t.quarantined() == [0]
    assert t.close_window() == []
    assert t.close_window() == [0]
    assert t.state_of(0) == DEGRADED
    t.observe(0, "m", realized_s=0.1, committed_s=0.1)
    assert t.state_of(0) == HEALTHY
    t.record_failure(0, "crash")
    t.record_failure(1, "crash")
    assert t.active_wids([Worker(0), Worker(1)]) is None


# ------------------------------------------------------------ streaming


def _two_model_app(profile_cls, app_cls, penalty="step"):
    models = [profile_cls("fast", recalls=np.array([0.75, 0.75]), latency_s=0.02,
                          load_latency_s=0.01),
              profile_cls("acc", recalls=np.array([0.95, 0.95]), latency_s=0.09,
                          load_latency_s=0.04, latency_model=(0.06, 0.03))]
    return {"a": app_cls(name="a", models=models, penalty=penalty)}


def _committed_states(seed, capacity=None):
    """(reference state, port state) after three windows of per-request
    placement on a three-worker pool, committed by each package's
    ``evaluate``; plus the per-window requests."""
    rng = np.random.default_rng(seed)
    out = []
    for pkg in (J, T):
        m = _mods(pkg)
        apps = _two_model_app(m["profile"], m["app"])
        pool = [m["worker"](0), m["worker"](1, speed=2.0), m["worker"](4, load_scale=0.5)]
        state_cls = JStreamingState if pkg is J else StreamingState
        state = state_cls(worker_ids=[0, 1, 4], memory_capacity_bytes=capacity)
        if capacity is not None:
            state.register_sizes({"fast": 3, "acc": 5})
        out.append((m, apps, pool, state))
    for w in range(3):
        now = 0.1 * (w + 1)
        n = int(rng.integers(3, 8))
        deadlines = rng.uniform(0.05, 0.6, n)
        for m, apps, pool, state in out:
            reqs = [m["request"](rid=10 * w + i, app="a", arrival_s=now - 0.05,
                                 deadline_s=now + float(deadlines[i]), true_label=0)
                    for i in range(n)]
            if m["request"] is JRequest:
                sched = j_multiworker(reqs, apps, pool, now, per_request=bool(w % 2),
                                      state=state)
                j_evaluate(sched, apps, now, state=state)
            else:
                sched = t_multiworker(reqs, apps, pool, now, per_request=bool(w % 2),
                                      state=state, device="cpu")
                t_evaluate(sched, apps, now, state=state, device="cpu")
    return out[0][3], out[1][3]


def _state_view(state):
    return {
        "timelines": [(w, tl.t, list(tl._resident)) for w, tl in state.items()],
        "backlog": {w: [(b.rids, b.model, b.batch_id, b.est_start_s, b.est_latency_s,
                         b.t_before, b.residency_before, b.dispatched) for b in bs]
                    for w, bs in sorted(state.backlog.items())},
        "undispatched": state.undispatched_backlog(),
        "requests": sorted(r.rid for r in state.backlog_requests()),
        "signature": state.signature(),
    }


@pytest.mark.parametrize("capacity", [None, 8], ids=["single-slot", "evicting"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preempt_matches_reference(seed, capacity):
    """Dispatch marks on a random subset, then preemption at three closes:
    the same withdrawn and expired requests, the same rollback of
    busy-until times and LRU residency, the same surviving backlog."""
    js, ts = _committed_states(seed, capacity)
    assert _state_view(ts) == _state_view(js)
    assert any(js.backlog.values())
    rng = np.random.default_rng(seed + 100)
    # Marks on the first two windows' batches; the last window's stay
    # withdrawable at its own close.
    rids = sorted(r.rid for r in js.backlog_requests() if r.rid < 20)
    marked = [int(r) for r in rng.choice(rids, size=max(1, len(rids) // 2), replace=False)]
    js.mark_dispatched(marked)
    ts.mark_dispatched(marked)
    assert _state_view(ts) == _state_view(js)
    withdrawn = 0
    for now in (0.3, 0.45, 0.7):
        jr, je = js.preempt(now)
        tr, te = ts.preempt(now)
        assert [r.rid for r in tr] == [r.rid for r in jr]
        assert [r.rid for r in te] == [r.rid for r in je]
        assert _state_view(ts) == _state_view(js)
        withdrawn += len(tr) + len(te)
    assert withdrawn > 0


@pytest.mark.parametrize("where", ["tail", "middle", "mixed", "unknown"])
def test_withdraw_matches_reference(where):
    """Failed batches withdrawn: a tail rolls the timeline back exactly, a
    batch in the middle of a queue leaves the log only."""
    js, ts = _committed_states(5)
    queue = max(js.backlog, key=lambda w: len(js.backlog[w]))
    batches = js.backlog[queue]
    assert len(batches) >= 3
    pick = {"tail": batches[-1].rids[:1], "middle": batches[1].rids[:1],
            "mixed": batches[-1].rids + batches[0].rids, "unknown": [999]}[where]
    jr, tr = js.withdraw(set(pick)), ts.withdraw(set(pick))
    assert [r.rid for r in tr] == [r.rid for r in jr]
    assert (len(tr) > 0) == (where != "unknown")
    assert _state_view(ts) == _state_view(js)


def test_backlog_arrays_round_trip_like_reference():
    """``to_arrays(include_backlog=True)`` equals the reference's encoding;
    ``from_arrays`` rebuilds the state, dispatch marks included, and the
    rebuilt state and a clone preempt as the original does."""
    js, ts = _committed_states(7, capacity=8)
    rids = sorted(r.rid for r in js.backlog_requests())
    for s in (js, ts):
        s.mark_dispatched(rids[1::3])
    gids = {"fast": 0, "acc": 1}
    jt, jres, jreg, jb = js.to_arrays(gids, include_backlog=True)
    tt, tres, treg, tb = ts.to_arrays(gids, include_backlog=True)
    for a, b in ((tt, jt), (tres, jres), (treg, jreg)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sorted(tb) == sorted(jb)
    for key in tb:
        if key == "members":
            assert [r.rid for r in tb[key]] == [r.rid for r in jb[key]]
        else:
            assert tb[key].dtype == jb[key].dtype and np.array_equal(tb[key], jb[key]), key
    assert tb["dispatched"].any() and not tb["dispatched"].all()
    rebuilt = StreamingState.from_arrays(tt, tres, treg, ["fast", "acc"], wids=[0, 1, 4],
                                         memory_capacity_bytes=8, backlog=tb)
    clone = ts.clone()
    assert _state_view(rebuilt) == _state_view(ts) == _state_view(clone)
    got = [[r.rid for r in out] for s in (rebuilt, clone, ts) for out in s.preempt(0.3)]
    want = [[r.rid for r in out] for out in js.preempt(0.3)]
    assert got == want * 3
    assert _state_view(rebuilt) == _state_view(clone) == _state_view(ts) == _state_view(js)


@pytest.mark.parametrize("scale", ["uniform", "per-worker", "none"])
def test_evaluate_latency_scale_matches_reference(scale):
    """The committed replay under drift scales (inference stretched, swap
    not): completions, utilities, busy seconds and committed latencies
    bit for bit."""
    fns = {"uniform": lambda w, m: 2.0,
           "per-worker": lambda w, m: {0: 1.0, 1: 0.75, 4: 1.375}[w] * (1.5 if m == "acc" else 1),
           "none": None}
    out = []
    for pkg in (J, T):
        m = _mods(pkg)
        apps = _two_model_app(m["profile"], m["app"], penalty="sigmoid")
        pool = [m["worker"](0), m["worker"](1, speed=2.0), m["worker"](4)]
        reqs = [m["request"](rid=i, app="a", arrival_s=0.0, deadline_s=0.1 + 0.03 * i,
                             true_label=i % 2) for i in range(9)]
        if pkg is J:
            sched = j_multiworker(reqs, apps, pool, 0.1)
            res = j_evaluate(sched, apps, 0.1, num_workers=5, latency_scale=fns[scale])
        else:
            sched = t_multiworker(reqs, apps, pool, 0.1, device="cpu")
            res = t_evaluate(sched, apps, 0.1, num_workers=5, latency_scale=fns[scale],
                             device="cpu")
        out.append((res, [(e.est_start_s, e.est_latency_s) for e in sched.sorted_entries()]))
    (jres, jlat), (tres, tlat) = out
    for key in ("completions", "utilities", "accuracies", "deadlines"):
        assert getattr(tres, key).tobytes() == getattr(jres, key).tobytes(), key
    assert (tres.mean_utility, tres.violations, tres.worker_busy_s, tres.span_s) == \
        (jres.mean_utility, jres.violations, jres.worker_busy_s, jres.span_s)
    assert tlat == jlat


# ------------------------------------------------------------ supervision


def _sc_app(profile_cls, app_cls):
    """Two variants the executor answers without a model (short-circuit
    names) and the scheduler sees with ordinary profiled latencies."""
    models = [profile_cls("fast:short_circuit", recalls=np.array([0.75, 0.75]), latency_s=0.02,
                          load_latency_s=0.01),
              profile_cls("acc:short_circuit", recalls=np.array([0.95, 0.95]), latency_s=0.09,
                          load_latency_s=0.04)]
    return {"a": app_cls(name="a", models=models, penalty="step")}


def _sc_pool(pkg, workers=(0, 1)):
    m = _mods(pkg)
    return m["pool"]([m["worker"](w) for w in workers], variants={}, **m["extra"])


def _entries(pkg, spec):
    """A schedule of (rid, model, worker, order, batch_id, start) rows."""
    entry, sched = (JEntry, JSchedule) if pkg is J else (ScheduleEntry, Schedule)
    req = _mods(pkg)["request"]
    return sched(entries=[
        entry(request=req(rid=rid, app="a", arrival_s=0.0, deadline_s=5.0, true_label=0),
              model=model, order=order, worker=w, batch_id=b, est_start_s=start,
              est_latency_s=0.05)
        for rid, model, w, order, b, start in spec])


CASCADE = [(0, "sp:short_circuit", 0, 1, 0, 0.0), (1, "sp:short_circuit", 0, 2, 1, 0.1),
           (2, "sp:short_circuit", 0, 3, 2, 0.2), (3, "sp:short_circuit", 1, 1, 3, 0.0)]


def _failures(outcome):
    return [(f.worker, f.request_ids, f.model, f.kind, f.batch_index, f.cascaded)
            for f in outcome.failures]


@pytest.mark.parametrize("kind", ["crash", "transient", "swap_fail", "hang"])
def test_supervised_faults_match_reference(kind):
    """An injected fault at batch 1 of worker 0: a crash fails it and
    every later batch of the lane (cascaded), a transient or swap failure
    that batch only, a hang inflates its decode seconds; the other lane
    runs untouched."""
    outs = []
    for pkg in (J, T):
        m = _mods(pkg)
        inj = (JFaultInjector if pkg is J else FaultInjector)(m["plan"](specs=(
            m["spec"](kind, window=3, worker=0, batch=1, delay_s=0.25),)))
        out = _sc_pool(pkg).execute_supervised(_entries(pkg, CASCADE), lambda r: None,
                                               injector=inj, window=3)
        outs.append((_failures(out), [(r.worker, r.request_ids, r.decode_s) for r in out.reports],
                     out.timed_out, inj.log))
    assert outs[1] == outs[0]
    failures = outs[1][0]
    if kind == "crash":
        assert [(f[3], f[5]) for f in failures] == [("crash", False), ("crash", True)]
    elif kind == "hang":
        assert failures == [] and (0, [1], 0.25) in outs[1][1]
    else:
        assert [f[3] for f in failures] == [kind]


def test_supervised_errors_and_gather_all_match_reference():
    """A batch that raises becomes a ``kind="error"`` record under
    supervision; unsupervised, the other lane still runs and accounts its
    seconds before the error is re-raised."""
    spec = [(0, "real", 0, 1, 0, 0.0), (1, "sp:short_circuit", 1, 1, 1, 0.0)]
    for pkg in (J, T):
        out = _sc_pool(pkg).execute_supervised(_entries(pkg, spec),
                                               lambda r: np.zeros(4, np.int32))
        assert [r.request_ids for r in out.reports] == [[1]] and out.reports[0].worker == 1
        assert [(f.kind, f.request_ids) for f in out.failures] == [("error", [0])]
        assert "KeyError" in out.failures[0].error and out.failed_rids() == {0}
        pool, dispatched = _sc_pool(pkg), []
        with pytest.raises(KeyError):
            pool.execute_schedule(_entries(pkg, spec), lambda r: np.zeros(4, np.int32),
                                  on_dispatch=dispatched.append)
        assert [1] in dispatched and pool.wall_s > 0.0
    with pytest.raises(ValueError, match="failures sink"):
        _sc_pool(T).lanes[0].execute(_entries(T, spec).entries, lambda r: None,
                                     injector=FaultInjector(FaultPlan()))


def test_dispatch_gating_matches_reference():
    """``until`` dispatches only the batches committed to start before it,
    and ``on_dispatch`` sees exactly those."""
    spec = [(0, "sp:short_circuit", 0, 1, 0, 0.10), (1, "sp:short_circuit", 0, 2, 1, 0.25),
            (2, "sp:short_circuit", 1, 1, 2, 0.12), (3, "sp:short_circuit", 1, 2, 3, 0.30)]
    got = []
    for pkg in (J, T):
        dispatched = []
        reports = _sc_pool(pkg).execute_schedule(_entries(pkg, spec), lambda r: None,
                                                 until=0.2, on_dispatch=dispatched.append)
        got.append(([r.request_ids for r in reports], dispatched))
    assert got[1] == got[0] == ([[0], [2]], [[0], [2]])


def test_lane_deadline_is_recorded_and_joined():
    """A lane that overruns the shared deadline is recorded in
    ``timed_out`` and still joined: its reports arrive."""
    profiles = {"slow": ModelProfile("slow", recalls=[0.9, 0.9], latency_s=0.25,
                                     load_latency_s=0.0)}
    backend = SimulatedBackend(profiles, occupancy="sleep")
    pool = ExecutorPool([Worker(0), Worker(1)], backend_factory=backend.spawn)
    spec = [(0, "slow", 0, 1, 0, 0.0), (1, "sp:short_circuit", 1, 1, 1, 0.0)]
    with pool:
        out = pool.execute_supervised(_entries(T, spec), lambda r: np.zeros(4, np.int32),
                                      timeout_s=0.02)
        fast = pool.execute_supervised(_entries(T, spec), lambda r: np.zeros(4, np.int32),
                                       timeout_s=30.0)
    assert out.timed_out == [0] and fast.timed_out == []
    assert sorted(r.request_ids[0] for r in out.reports) == [0, 1]
    assert out.failures == []


def test_execute_async_joins_like_supervised():
    """``execute_async`` returns at once; its result is the supervised
    outcome, stamped with the lanes' start and finish."""
    plan = FaultPlan(specs=(FaultSpec("crash", window=0, worker=0, batch=0),))
    with _sc_pool(T) as pool:
        pending = pool.execute_async(_entries(T, CASCADE), lambda r: None,
                                     injector=FaultInjector(plan))
        assert isinstance(pending, PendingExecution)
        out = pending.result()
        assert pending.done() and pending.finished_at >= pending.started_at
        want = _sc_pool(T).execute_supervised(_entries(T, CASCADE), lambda r: None,
                                              injector=FaultInjector(plan))
        assert _failures(out) == _failures(want)
        assert [r.request_ids for r in out.reports] == [r.request_ids for r in want.reports]
        unsupervised = pool.execute_async(_entries(T, CASCADE), lambda r: None,
                                          supervised=False)
        assert unsupervised.result().failures == []
    assert pool._coord is None and pool._tp is None


# ------------------------------------------------------------ the server


def _sim_profiles(cls):
    return {
        "small": cls("small", recalls=[0.74, 0.72], latency_s=0.010, load_latency_s=0.02,
                     memory_bytes=3_000),
        "big": cls("big", recalls=[0.93, 0.91], latency_s=0.045, load_latency_s=0.08,
                   latency_model=(0.025, 0.02), memory_bytes=5_000),
    }


def _closed_plan(pkg):
    """A crash on worker 1 at window 1, a straggler pinned to worker 2
    (every batch inflated by 1 s) and seeded transients."""
    m = _mods(pkg)
    return m["plan"](specs=(m["spec"]("crash", window=1, worker=1, batch=0),
                            m["spec"]("hang", worker=2, delay_s=1.0, count=None)),
                     rates={"transient": 0.1}, seed=7)


def _sim_serve(pkg, policy, preempt=False, closed=False, overlap=False, lane="thread",
               n=24, server_cls=None, **kwargs):
    """Serve ``n`` requests over three SimulatedBackend lanes, one twice as
    fast, under a residency budget.  Returns (decisions, records,
    counters, sorted fired faults, server)."""
    m = _mods(pkg)
    profiles = _sim_profiles(m["profile"])
    app = m["app"](name="lm", models=list(profiles.values()), penalty="sigmoid")
    if closed:
        kwargs = dict(kwargs, faults=_closed_plan(pkg), health=True)
    srv = (server_cls or m["server"])(
        {"lm": app}, m["policy"](policy), backend=m["backend"](profiles, occupancy="none"),
        prompt_fn=lambda r: (np.arange(8, dtype=np.int32) + int(r.rid)) % 256,
        workers=[m["worker"](0), m["worker"](1, speed=2.0), m["worker"](2)], lane=lane,
        preempt=preempt, overlap=overlap, memory_capacity_bytes=7_000,
        **kwargs, **m["extra"])
    reqs = [m["request"](rid=i, app="lm", arrival_s=0.015 * i,
                         deadline_s=0.015 * i + 0.25 + 0.1 * (i % 3), true_label=i % 2)
            for i in range(n)]
    with srv:
        outs, stats = srv.run(reqs)
    log = sorted(srv.injector.log) if srv.injector is not None else []
    return (_decisions(outs), dict(srv._records), {k: getattr(stats, k) for k in COUNTERS},
            log, srv)


@functools.cache
def _reference(policy, preempt, closed, overlap):
    """The reference's run of a grid cell (thread lanes), made once."""
    return _sim_serve(J, policy, preempt, closed, overlap)[:4]


@pytest.mark.parametrize("lane", ["serial", "thread"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("closed", [False, True], ids=["no-faults", "faults+health"])
@pytest.mark.parametrize("preempt", [False, True], ids=["no-preempt", "preempt"])
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_edge_server_closed_loop_matches_reference(policy, preempt, closed, overlap, lane):
    """Decisions, per-request records, every counter (drift ratios and
    utilities bit for bit) and the fired faults equal the reference's."""
    dec, records, counters, log, srv = _sim_serve(T, policy, preempt, closed, overlap, lane)
    assert (dec, records, counters, log) == _reference(policy, preempt, closed, overlap)
    assert sorted(records) == list(range(24)) if srv._use_records else not records
    assert srv.pool._coord is None and srv._inflight is None


def test_closed_loop_scenario_exercises_every_path():
    """The grid's scenario really preempts, fails, retries, quarantines the
    straggler and releases it."""
    _, _, counters, log, srv = _sim_serve(T, "LO-EDF", preempt=True, closed=True,
                                          overlap=True)
    assert counters["preempted"] > 0 and counters["dropped"] > 0
    assert counters["failed_batches"] > 0 and counters["retries"] > 0
    assert {kind for *_, kind, _ in log} >= {"crash", "hang", "transient"}
    assert srv.health._health[2].quarantines >= 1
    assert srv.stats.overlap_saved_s >= 0.0
    d = srv.stats.as_dict()
    assert set(d["realized_over_profiled"]) == {0, 1, 2} and "worker_utilization" in d


def test_edge_server_process_lanes_match_reference():
    """Process lanes poll the injector in the parent's lane threads: the
    same decisions, records, counters and faults as the reference's
    thread lanes, overlapped and preemptive."""
    got = _sim_serve(T, "LO-EDF", True, True, True, lane="process", n=12)[:4]
    assert got == _sim_serve(J, "LO-EDF", True, True, True, n=12)[:4]


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_overlap_decides_as_sync(policy):
    """``overlap=True`` changes when the host decides, never what."""
    sync = _sim_serve(T, policy, preempt=True, closed=True)[:4]
    assert _sim_serve(T, policy, preempt=True, closed=True, overlap=True)[:4] == sync


class _SpyServer(EdgeServer):
    """Counts the schedules taken against the committed state: in overlap
    mode the first window plus every invalidated speculation."""

    real_schedules = 0

    def _schedule_requests(self, requests, now, state):
        if state is self.state:
            self.real_schedules += 1
        return super()._schedule_requests(requests, now, state)


def test_speculation_survives_quiet_windows_and_falls_to_faults():
    quiet = _sim_serve(T, "LO-EDF", overlap=True, server_cls=_SpyServer)[4]
    assert quiet.stats.windows > 2 and quiet.real_schedules == 1
    faulted = _sim_serve(T, "LO-EDF", closed=True, overlap=True, server_cls=_SpyServer)
    assert faulted[2]["retries"] > 0 and faulted[4].real_schedules >= 2
    assert faulted[:4] == _reference("LO-EDF", False, True, True)


@pytest.mark.parametrize("preempt", [False, True])
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_empty_fault_plan_decides_as_plain_server(policy, preempt):
    """Supervision with no fault firing reproduces the unsupervised server."""
    plain = _sim_serve(T, policy, preempt)
    supervised = _sim_serve(T, policy, preempt, faults=FaultPlan())
    assert supervised[0] == plain[0]
    # Per-request records sum the utilities one by one, the plain server
    # window by window: the reference's two means differ in the last bit too.
    assert supervised[2]["mean_utility"] == pytest.approx(plain[2]["mean_utility"], rel=1e-12)
    assert supervised[2]["failed_batches"] == supervised[2]["retries"] == 0


def _sc_server(pkg, **kwargs):
    m = _mods(pkg)
    workers = [m["worker"](0), m["worker"](1)]
    return m["server"](_sc_app(m["profile"], m["app"]), m["policy"]("LO-EDF"),
                       executor=m["pool"](workers, variants={}, **m["extra"]),
                       prompt_fn=lambda r: None, workers=workers, **kwargs, **m["extra"])


def _sc_trace(pkg, n, gap, deadline):
    req = _mods(pkg)["request"]
    return [req(rid=i, app="a", arrival_s=gap * i, deadline_s=deadline, true_label=0)
            for i in range(n)]


@pytest.mark.parametrize("case", ["crash", "exhaustion", "straggler"])
def test_recovery_scenarios_match_reference(case):
    """A crash loses no request and counts none twice; a fault that always
    fires exhausts the retry budget and drops each request once; a
    straggler is quarantined, masked out and re-probed — as the
    reference's server does each."""
    out = []
    for pkg in (J, T):
        m = _mods(pkg)
        if case == "crash":
            kw = dict(faults=m["plan"](specs=(m["spec"]("crash", window=0, worker=0, batch=0),)),
                      health=True)
            trace = _sc_trace(pkg, 10, 0.01, 3.0)
        elif case == "exhaustion":
            kw = dict(faults=m["plan"](specs=(m["spec"]("transient", count=None),)),
                      retry_budget=2)
            trace = _sc_trace(pkg, 4, 0.01, 50.0)
        else:
            kw = dict(faults=m["plan"](specs=(
                m["spec"]("hang", worker=0, window=0, delay_s=1.0),
                m["spec"]("hang", worker=0, window=1, delay_s=1.0))),
                health=m["tracker"]([0, 1], cooldown_windows=2))
            trace = _sc_trace(pkg, 24, 0.02, 8.0)
        srv = _sc_server(pkg, **kw)
        outs, stats = srv.run(trace)
        out.append((_decisions(outs), dict(srv._records), {k: getattr(stats, k) for k in COUNTERS},
                    dict(srv._attempts), sorted(srv.injector.log), srv, outs))
    assert out[1][:5] == out[0][:5]
    srv, stats, outs = out[1][5], out[1][5].stats, out[1][6]
    assert sorted(srv._records) == list(range(len(srv._records)))
    if case == "crash":
        assert stats.failed_batches >= 1 and stats.retries >= 1
        assert stats.dropped_after_retry == 0 and srv.health._health[0].quarantines >= 1
    elif case == "exhaustion":
        assert stats.dropped_after_retry == 4 and srv._attempts == {rid: 3 for rid in range(4)}
        assert all(rec == (0.0, True) for rec in srv._records.values())
    else:
        assert srv.health._health[0].quarantines >= 1 and srv.health._health[1].quarantines == 0
        assert any(all(e.worker == 1 for e in o["schedule"].entries) for o in outs)
        assert srv.health.state_of(0) in (HEALTHY, DEGRADED)


def test_preempt_drops_expired_backlog_like_reference():
    """Twelve requests of one deadline the pool cannot all start in time:
    the unstarted tail is withdrawn expired at the next close and dropped
    with a recorded violation, as in the reference."""
    out = []
    for pkg in (J, T):
        m = _mods(pkg)
        trace = _sc_trace(pkg, 12, 0.005, 0.18) + [
            m["request"](rid=50, app="a", arrival_s=0.15, deadline_s=0.6, true_label=0)]
        srv = _sc_server(pkg, preempt=True)
        outs, stats = srv.run(trace)
        out.append((_decisions(outs), dict(srv._records), {k: getattr(stats, k) for k in COUNTERS}))
    assert out[1] == out[0]
    assert out[1][2]["dropped"] >= 1 and out[1][2]["requests"] == 13


def test_closed_loop_options_need_a_pool():
    m = _mods(T)
    app = _sc_app(m["profile"], m["app"])
    with pytest.raises(ValueError, match="faults/health"):
        EdgeServer(app, tsched.make_policy("LO-EDF"), faults=FaultPlan(), device="cpu")
    with pytest.raises(ValueError, match="overlap"):
        EdgeServer(app, tsched.make_policy("LO-EDF"), overlap=True, device="cpu")


# ------------------------------------------------------------ quarantine, drift (C1)


def _sig(sched):
    return [(e.request.rid, e.model, e.order, e.worker, e.batch_id, e.est_start_s,
             e.est_latency_s) for e in sched.sorted_entries()]


def test_quarantine_mask_matches_fast_and_scalar_paths():
    """A quarantined worker receives no placement, and the port's fast and
    scalar paths equal the reference's numpy fast path and scalar loop
    under the tracker's mask (in place of tests/test_faults.py's pipeline
    comparison, which the installed JAX cannot run)."""
    tracker = HealthTracker([0, 1])
    tracker.record_failure(0, "crash")
    mask = tracker.active_wids([Worker(0), Worker(1, speed=2.0)])
    assert mask == {1}
    scale = {(1, "fast:short_circuit"): 1.5}
    jw, tw = [JWorker(0), JWorker(1, speed=2.0)], [Worker(0), Worker(1, speed=2.0)]
    japps, tapps = _sc_app(JModelProfile, JApplication), _sc_app(ModelProfile, Application)
    jreqs, treqs = _sc_trace(J, 6, 0.0, 0.6), _sc_trace(T, 6, 0.0, 0.6)
    want = j_fast_multiworker(jreqs, japps, jw, 0.1, lat_scale=scale, worker_mask=mask)
    got = t_multiworker(treqs, tapps, tw, 0.1, lat_scale=scale, worker_mask=mask,
                        device="cpu")
    assert _sig(got) == _sig(want) and {e.worker for e in got.entries} == {1}
    scalar_j = j_multiworker(jreqs, japps, jw, 0.1, fastpath=False, worker_mask=mask)
    scalar_t = t_multiworker(treqs, tapps, tw, 0.1, fastpath=False, worker_mask=mask,
                             device="cpu")
    fast_t = t_multiworker(treqs, tapps, tw, 0.1, worker_mask=mask, device="cpu")
    assert _sig(scalar_t) == _sig(scalar_j) == _sig(fast_t)
    tracker.record_failure(1, "crash")
    assert tracker.active_wids([Worker(0), Worker(1)]) is None
    with pytest.raises(ValueError, match="at least one worker"):
        t_multiworker(treqs, tapps, tw, 0.1, worker_mask=set(), device="cpu")


@pytest.mark.parametrize("per_request", [True, False], ids=["per-request", "grouped"])
def test_lat_scale_steers_placement_like_fast_path(per_request):
    """Drift scales steer placement (a heavily scaled worker loses work),
    as in the reference's numpy fast path."""
    scale = {(0, "fast:short_circuit"): 6.0, (0, "acc:short_circuit"): 6.0}
    jw, tw = [JWorker(0), JWorker(1)], [Worker(0), Worker(1)]
    japps, tapps = _sc_app(JModelProfile, JApplication), _sc_app(ModelProfile, Application)
    jreqs, treqs = _sc_trace(J, 8, 0.0, 0.5), _sc_trace(T, 8, 0.0, 0.5)
    plain = t_multiworker(treqs, tapps, tw, 0.1, per_request=per_request, device="cpu")
    scaled = t_multiworker(treqs, tapps, tw, 0.1, per_request=per_request, lat_scale=scale,
                           device="cpu")
    want = j_fast_multiworker(jreqs, japps, jw, 0.1, per_request=per_request, lat_scale=scale)
    assert _sig(scaled) == _sig(want)
    assert _sig(plain) == _sig(j_fast_multiworker(jreqs, japps, jw, 0.1,
                                                  per_request=per_request))
    if per_request:
        assert sum(e.worker == 0 for e in scaled.entries) < \
            sum(e.worker == 0 for e in plain.entries)


# ------------------------------------------------------------ real models


@pytest.mark.parametrize("policy", ["LO-EDF", "Grouped"])
def test_preempt_on_reduced_mamba_matches_reference(policy):
    """Reduced mamba2-130m on two thread lanes under preemption: the flush
    runs every gated batch; decisions, records, executed batches and
    counters equal the reference's (health off, so no decision depends on
    measured time)."""
    variants = {"small": J_FAMILIES["mamba2-130m"]}
    jexec, texec = _executors(variants)
    out = []
    for pkg, executor in ((J, jexec), (T, texec)):
        m = _mods(pkg)
        app = m["app"](name="lm", models=[m["profile"](
            "small", recalls=np.array([0.7, 0.7]), latency_s=0.08, load_latency_s=0.01)],
            penalty="sigmoid")
        vocab = variants["small"][0].vocab_size
        srv = m["server"]({"lm": app}, m["policy"](policy), executor=executor,
                          prompt_fn=lambda r: np.random.default_rng(r.rid).integers(
                              0, vocab, 8).astype(np.int32),
                          workers=[m["worker"](0), m["worker"](1)], preempt=True, **m["extra"])
        reqs = [m["request"](rid=i, app="lm", arrival_s=0.01 * i, deadline_s=5.0, true_label=0)
                for i in range(6)]
        with srv:
            outs, stats = srv.run(reqs)
        executed = sorted(rid for o in outs for rep in (o["reports"] or [])
                          for rid in rep.request_ids)
        out.append((_decisions(outs), dict(srv._records), executed,
                    {k: getattr(stats, k) for k in ("windows", "requests", "violations",
                                                    "mean_utility", "preempted", "dropped",
                                                    "swaps", "worker_busy_s", "span_s")},
                    srv.state.undispatched_backlog()))
    assert out[1] == out[0]
    assert out[1][2] == list(range(6)) and out[1][4] == 0
    if policy == "LO-EDF":  # six batches of one: flush windows ran past the horizon
        assert out[1][3]["windows"] > 1 and out[1][3]["preempted"] > 0


def test_readmitted_requests_keep_their_evidence():
    """Re-admitted requests are not ingested again: the SneakPeek stage
    leaves a request with evidence as it is."""
    from repro_torch.core.sneakpeek import KNNSneakPeek, attach_sneakpeek

    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    y = rng.integers(0, 2, 200).astype(np.int32)
    m = _mods(T)
    apps = {"a": m["app"](name="a", models=list(_sim_profiles(ModelProfile).values()))}
    sneaks = {"a": KNNSneakPeek(x, y, 2, k=5, device="cpu")}
    reqs = [Request(rid=i, app="a", arrival_s=0.0, deadline_s=1.0,
                    features=rng.normal(size=4).astype(np.float32)) for i in range(5)]
    attach_sneakpeek(reqs, apps, sneaks, device="cpu")
    before = copy.deepcopy([(r.evidence, r.theta) for r in reqs])
    for r in reqs:
        r.features = -r.features  # a second ingest would change the evidence
    attach_sneakpeek(reqs, apps, sneaks, device="cpu")
    for r, (ev, th) in zip(reqs, before):
        np.testing.assert_array_equal(r.evidence, ev)
        np.testing.assert_array_equal(r.theta, th)
