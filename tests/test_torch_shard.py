"""The port's sharded window scheduling (``repro_torch.core.shard``) against
its unsharded pipeline and against the JAX package's ``ShardedWindowPipeline``.

On the CPU (``device="cpu"``) the shards' blocks share the host through
``force_shard_devices`` (ROADMAP §3, P9), and the ``shard_round`` kernel
runs its plain versions (``kernels/shard_round/ref.py``):

* the sharded pipeline against the unsharded one, full decision tuples
  (rid, model, order, batch id, worker, start, latency, bit-equal) and
  ``chunk_stats``, for five policies x chunk 0, 3, 16 x 2, 3, 4, 8
  shards x theta all/some/none; with ``chunk`` > 0 the sharded rounds
  and conflicts are the unsharded chunked scan's, with ``chunk=0`` those
  of the chunked scan whose chunk is the window (one round speculates
  everything left); carried state and a capacity that evicts; three and
  four workers on 4 and 8 shards (padded workers never win);
* the reference's ``ShardedWindowPipeline`` itself, in a child process
  with 2 and 4 forced host devices and its x64 switch repaired there
  (ROADMAP C1): decisions and ``last_shard_stats`` of five policies x
  chunk 0, 3 and of the three-worker pool equal the port's at the same
  shard count; and one window that pins two reference faults: its sharded
  chunked placement leaves its unsharded decisions (C5, the port keeps
  them) and its compiled speculation counts one round fewer (C4);
* ``pad_rows``, ``resolve_num_shards`` and ``row_specs`` against the
  reference's rules; one shard and the numpy backend delegating verbatim
  (the same scans, the same cached tables, no ``shard_round`` call);
* ``Simulation(shard=N)`` against ``Simulation(pipeline=True)`` over six
  windows, and ``EdgeServer(shard=N, overlap=True, preempt=...)`` over
  ``SimulatedBackend`` lanes against the reference's server.

Tolerances: none.  Every compared value is float64 in the reference's
association, so decisions and times are bit-equal.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import POLICY_NAMES
from repro.core import shard as jshard
from repro_torch.core import pipeline as tpipe
from repro_torch.core import scheduler as tsched
from repro_torch.core import shard as tshard
from repro_torch.core import simulator as tsim
from repro_torch.core.evaluation import evaluate as t_evaluate
from repro_torch.core.multiworker import Worker
from repro_torch.core.sneakpeek import attach_sneakpeek as t_attach
from repro_torch.core.streaming import StreamingState
from repro_torch.data import applications as tapps
from repro_torch.kernels.shard_round import ops as shard_ops
from test_torch_closed_loop import T as T_PKG
from test_torch_closed_loop import _reference as closed_loop_reference
from test_torch_closed_loop import _sim_serve

REPO = Path(__file__).resolve().parents[1]
THETA_MODES = ["all", "some", "none"]
CAPACITIES = [None, 400 * 2**20]
CAPACITY_IDS = ["single-slot", "evicting"]
# Three and four workers, as (wid, speed, load_scale): on 4 and 8 shards
# some shards hold padded workers only, some a real and a padded one.
POOLS = {
    "three": [(0, 1.0, 1.0), (1, 1.7, 1.0), (2, 0.6, 1.0)],
    "four": [(0, 1.0, 1.0), (1, 2.0, 1.0), (2, 0.5, 1.0), (3, 1.0, 2.0)],
}
LONG_CHUNK = 10_000  # a chunk past any window here: one round speculates all


@pytest.fixture(autouse=True)
def forced():
    """Eight shard blocks may share the host (P9), for one test."""
    prev = tshard.force_shard_devices(8)
    yield
    tshard.force_shard_devices(prev)


@pytest.fixture(scope="module")
def suite():
    return tapps.build_benchmark_suite(backend="numpy", seed=0, device="cpu")


def _window(suite, seed, theta="all", per_app=6, start_rid=0, shift=0.0):
    apps, sneaks = suite
    reqs = tapps.make_requests(list(tapps.APP_SPECS.values()), per_app=per_app,
                               deadline_std_s=0.05, seed=seed, start_rid=start_rid)
    for r in reqs:
        r.arrival_s += shift
        r.deadline_s += shift
    if theta != "none":
        t_attach(reqs, apps, sneaks, device="cpu")
        if theta == "some":
            for r in reqs[::3]:
                r.theta = None
                r.evidence = None
    return reqs


def _sig(sched):
    return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
             e.est_latency_s) for e in sched.sorted_entries()]


def _pool(name):
    return [Worker(w, speed=s, load_scale=ls) for w, s, ls in POOLS[name]]


def _stats(pipe):
    st = pipe.last_shard_stats
    return None if st is None else (st["num_shards"], st["rounds"], st["conflicts"])


def _speculated(stats):
    return None if stats is None else (stats["rounds"], stats["conflicts"])


# ------------------------------------------------- sharded against unsharded


@pytest.mark.parametrize("theta", THETA_MODES)
@pytest.mark.parametrize("shards", [2, 3, 4, 8])
@pytest.mark.parametrize("chunk", [0, 3, 16])
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_sharded_matches_unsharded(suite, policy, chunk, shards, theta):
    """Decision tuples and ``chunk_stats`` equal the unsharded pipeline's;
    the sharded rounds and conflicts are the chunked scan's at ``chunk``
    (or at the window's length for ``chunk=0``).  7 requests per
    application: 21 rows, a multiple of none of the shard counts."""
    apps, _ = suite
    reqs = _window(suite, 1, theta, per_app=7)
    pol = tsched.make_policy(policy, pipeline=True, chunk=chunk)
    base = tpipe.WindowPipeline(apps, policy=pol, device="cpu").schedule(reqs, 0.1)
    pipe = tshard.ShardedWindowPipeline(apps, policy=pol, shard=shards, device="cpu")
    got = pipe.schedule(reqs, 0.1)
    assert _sig(got) == _sig(base)
    assert got.chunk_stats == base.chunk_stats
    spec = tpipe.WindowPipeline(apps, policy=pol, chunk=chunk or LONG_CHUNK,
                                device="cpu").schedule(reqs, 0.1)
    if spec.chunk_stats is None:  # the brute-force branch: nothing is scanned
        assert pipe.last_shard_stats is None
    else:
        assert _stats(pipe) == (shards,) + _speculated(spec.chunk_stats)


@pytest.mark.parametrize("capacity", CAPACITIES, ids=CAPACITY_IDS)
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_sharded_carried_state(suite, policy, capacity):
    """Two windows over one carried ``StreamingState`` (backlog and LRU
    residency): the sharded windows equal the unsharded ones."""
    apps, _ = suite
    sigs = []
    for cls, kw in ((tpipe.WindowPipeline, {}), (tshard.ShardedWindowPipeline, {"shard": 4})):
        pipe = cls(apps, policy=tsched.make_policy(policy, pipeline=True), device="cpu", **kw)
        state = StreamingState(num_workers=1, memory_capacity_bytes=capacity)
        out = []
        for w, (seed, now) in enumerate(((3, 0.1), (9, 0.35))):
            reqs = _window(suite, seed, start_rid=100 * w, shift=0.25 * w)
            sched = pipe.schedule(reqs, now, state=state)
            t_evaluate(sched, apps, now, state=state, device="cpu")
            out.append(_sig(sched))
        sigs.append(out)
    assert sigs[1] == sigs[0]


@pytest.mark.parametrize("chunk", [0, 3])
@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_sharded_pool(suite, policy, pool, shards, chunk):
    """Eq. 15 placement with the worker axis sharded (more shards than
    workers: padded workers in every shard past the pool) through
    ``schedule_window``: decisions and ``chunk_stats`` equal the
    unsharded pipeline's, and no entry lands on a padded worker."""
    apps, sneaks = suite
    reqs = _window(suite, 11, "none", per_app=5)
    workers = _pool(pool)
    state = StreamingState(worker_ids=[w.wid for w in workers],
                           memory_capacity_bytes=400 * 2**20)
    base, _ = tsched.schedule_window(tsched.make_policy(policy, pipeline=True, chunk=chunk),
                                     list(reqs), apps, 0.1, sneakpeeks=sneaks, workers=workers,
                                     state=state, device="cpu")
    got, _ = tsched.schedule_window(tsched.make_policy(policy, shard=shards, chunk=chunk),
                                    list(reqs), apps, 0.1, sneakpeeks=sneaks, workers=workers,
                                    state=state, device="cpu")
    assert _sig(got) == _sig(base)
    assert got.chunk_stats == base.chunk_stats
    assert {e.worker for e in got.sorted_entries()} <= {w.wid for w in workers}
    pipe = tshard.ShardedWindowPipeline(apps, policy=tsched.make_policy(policy, chunk=chunk),
                                        workers=workers, shard=shards, device="cpu")
    pipe.schedule(reqs, 0.1, state=state)
    groups = len({e.batch_id for e in got.sorted_entries()})
    want = (groups, 0) if not chunk else _speculated(base.chunk_stats)
    assert _stats(pipe) == (shards,) + want


def test_padding_rows_never_win(suite):
    """Three requests on eight shards: most blocks hold padding only;
    every decision matches and names a real request."""
    apps, _ = suite
    reqs = _window(suite, 2, per_app=1)
    for policy in ("LO-EDF", "SneakPeek", "MaxAcc-EDF"):
        pol = tsched.make_policy(policy, pipeline=True, tau=0)
        base = tpipe.WindowPipeline(apps, policy=pol, device="cpu").schedule(reqs, 0.1)
        got = tshard.ShardedWindowPipeline(apps, policy=pol, shard=8,
                                           device="cpu").schedule(reqs, 0.1)
        assert _sig(got) == _sig(base)
        assert sorted(e.request.rid for e in got.sorted_entries()) == \
            sorted(r.rid for r in reqs)


# ----------------------------------------------- the reference, sharded


_CHILD = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
    sys.path.insert(0, %r)
    import jax
    from repro.core import pipeline as jpipe

    # ROADMAP C1: the installed JAX has no jax.experimental.enable_x64.
    jpipe.WindowPipeline._enable_x64 = lambda self: jax.enable_x64(True)
    from repro.core import POLICY_NAMES, Worker, make_policy
    from repro.core.shard import ShardedWindowPipeline
    from repro.core.sneakpeek import attach_sneakpeek
    from repro.data.applications import APP_SPECS, build_benchmark_suite, make_requests

    ndev = %d
    apps, sneaks = build_benchmark_suite(backend="numpy", seed=0)
    reqs = make_requests(list(APP_SPECS.values()), per_app=5, deadline_std_s=0.05, seed=1)
    attach_sneakpeek(reqs, apps, sneaks)
    pool = [Worker(w, speed=s, load_scale=ls) for w, s, ls in %r]
    out = {}
    for workers in (None, pool):
        for name in POLICY_NAMES:
            for chunk in (0, 3):
                pipe = ShardedWindowPipeline(apps, policy=make_policy(name, pipeline=True),
                                             workers=workers, chunk=chunk, shard=ndev)
                sched = pipe.schedule(reqs, 0.1)
                sig = [(e.request.rid, e.model, e.order, e.batch_id, e.worker,
                        e.est_start_s, e.est_latency_s) for e in sched.sorted_entries()]
                key = f"{'pool' if workers else 'one'} {name} {chunk}"
                out[key] = [sig, sched.chunk_stats, pipe.last_shard_stats]
    # ROADMAP C5: a window on which the reference's sharded chunked Eq. 15
    # decides otherwise than its unsharded pipeline.
    reqs = make_requests(list(APP_SPECS.values()), per_app=12, deadline_std_s=0.05, seed=1)
    attach_sneakpeek(reqs, apps, sneaks)
    pool = [Worker(0), Worker(1, speed=2.0), Worker(2, speed=0.5)]
    for shard in (0, ndev):
        cls = ShardedWindowPipeline if shard else jpipe.WindowPipeline
        pipe = cls(apps, policy=make_policy("LO-EDF", pipeline=True), workers=pool, chunk=8,
                   **({"shard": shard} if shard else {}))
        sched = pipe.schedule(reqs, 0.1)
        out[f"c5 {shard}"] = [[(e.request.rid, e.model, e.order, e.batch_id, e.worker,
                                e.est_start_s, e.est_latency_s)
                               for e in sched.sorted_entries()], sched.chunk_stats]
    print(json.dumps({"devices": jax.local_device_count(), "runs": out}))
    """
)


@pytest.mark.parametrize("ndev", [2, 4])
def test_reference_sharded_pipeline_subprocess(suite, ndev):
    """The reference's ``ShardedWindowPipeline`` on ``ndev`` forced host
    devices (a child process: XLA_FLAGS must precede its first JAX
    import) against the port's at the same shard count: decision tuples,
    ``chunk_stats`` and ``last_shard_stats`` of five policies x chunk 0, 3,
    on one worker and on three."""
    code = _CHILD % (ndev, str(REPO / "src"), ndev, POOLS["three"])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ref["devices"] == ndev
    apps, _ = suite
    reqs = _window(suite, 1, per_app=5)
    for workers in (None, _pool("three")):
        for name in POLICY_NAMES:
            for chunk in (0, 3):
                pipe = tshard.ShardedWindowPipeline(
                    apps, policy=tsched.make_policy(name, pipeline=True), workers=workers,
                    chunk=chunk, shard=ndev, device="cpu")
                sched = pipe.schedule(reqs, 0.1)
                key = f"{'pool' if workers else 'one'} {name} {chunk}"
                got = json.loads(json.dumps([_sig(sched), sched.chunk_stats,
                                             pipe.last_shard_stats]))
                assert got == ref["runs"][key], key
    # C5: the reference's sharded chunked placement moves its carry chain
    # by the effective swap under the round's frozen carry, and so leaves
    # its own unsharded decisions; the port chains the raw swap, as the
    # unsharded scans do, and keeps them.  C4: the reference's compiled
    # speculation rounds one completion of this window a last bit away from
    # numpy's, which changes one speculated pick on a near-tie and so its
    # rounds (10 against the port's 11), never a decision.
    reqs = _window(suite, 1, per_app=12)
    pool = [Worker(0), Worker(1, speed=2.0), Worker(2, speed=0.5)]
    ported = []
    for kw in ({}, {"shard": ndev}):
        cls = tshard.ShardedWindowPipeline if kw else tpipe.WindowPipeline
        sched = cls(apps, policy=tsched.make_policy("LO-EDF", pipeline=True), workers=pool,
                    chunk=8, device="cpu", **kw).schedule(reqs, 0.1)
        ported.append(json.loads(json.dumps([_sig(sched), sched.chunk_stats])))
    (ref_sig, ref_stats), (ref_sharded_sig, _) = ref["runs"]["c5 0"], ref["runs"][f"c5 {ndev}"]
    assert ported[0] == ported[1] and ported[0][0] == ref_sig
    assert ref_sharded_sig != ref_sig
    assert (ported[0][1]["rounds"], ported[0][1]["conflicts"]) == (11, 10)
    assert (ref_stats["rounds"], ref_stats["conflicts"]) == (10, 10)


# ------------------------------------------------------- the helpers


class _FakeMesh:
    """Just enough of a JAX mesh for the reference's ``row_specs``."""

    def __init__(self, n):
        self.shape = {"shard": n}
        self.axis_names = ("shard",)


def test_pad_rows_and_resolve_match_reference():
    """``pad_rows`` as the reference's; ``resolve_num_shards`` as the
    reference's on its one host device, and on forced devices as on the
    reference's forced ones; beyond them both raise, the port naming
    ``force_shard_devices`` (P9)."""
    for n in (0, 1, 5, 7, 8, 9):
        for shards in (1, 2, 3, 4, 8):
            assert tshard.pad_rows(n, shards) == jshard.pad_rows(n, shards)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            tshard.pad_rows(3, bad)
        with pytest.raises(ValueError):
            jshard.pad_rows(3, bad)
    tshard.force_shard_devices(None)
    for flag in (False, True, 0, 1):
        assert tshard.resolve_num_shards(flag, "cpu") == jshard.resolve_num_shards(flag) == 1
    for flag in (-2, 2):
        with pytest.raises(ValueError):
            jshard.resolve_num_shards(flag)
        with pytest.raises(ValueError, match="force_shard_devices" if flag > 0 else "True"):
            tshard.resolve_num_shards(flag, "cpu")
    tshard.force_shard_devices(4)
    assert tshard.resolve_num_shards(True, "cpu") == 4
    assert tshard.resolve_num_shards(3, "cpu") == 3
    with pytest.raises(ValueError, match="force_shard_devices"):
        tshard.resolve_num_shards(5, "cpu")
    assert tshard.shard_mesh(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        tshard.force_shard_devices(0)


def test_row_specs_match_reference():
    """The split dim of each table: dim 0, an override, a scalar and an
    indivisible dim (replicated), as the reference's PartitionSpecs say."""
    shapes = {"acc": (8, 5, 3), "dl": (8,), "t0": (), "odd": (7,), "lat": (3, 8, 6),
              "rep": (8, 2)}
    axis = {"lat": 1, "rep": None}
    for n in (1, 2, 4, 8):
        want = {}
        for name, spec in jshard.row_specs(_FakeMesh(n), shapes, axis).items():
            dims = [i for i, a in enumerate(tuple(spec)) if a == "shard"]
            want[name] = dims[0] if dims else None
        assert tshard.row_specs([torch.device("cpu")] * n, shapes, axis) == want


def test_one_shard_and_numpy_delegate_verbatim(suite, monkeypatch):
    """``shard=1``, ``shard=True`` on one device and the numpy backend take
    the unsharded pipeline's route: the same scans on the same tables, the
    same cached table keys, no shard-round call and no shard stats."""
    apps, _ = suite
    reqs = _window(suite, 4, per_app=5)
    tshard.force_shard_devices(None)
    calls = []
    monkeypatch.setattr(tshard, "score_block", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(tshard, "chain", lambda *a, **k: calls.append(a))
    real_scan = tpipe._scan

    def spy(*args, **kw):
        calls.append(("scan", args[0], tuple(x.shape for x in args[5:10]), kw))
        return real_scan(*args, **kw)

    monkeypatch.setattr(tpipe, "_scan", spy)
    for name in ("LO-EDF", "SneakPeek", "MaxAcc-EDF"):
        for shard, backend in ((1, None), (True, None), (4, "numpy")):
            pol = tsched.make_policy(name, pipeline=True)
            tpipe._TABLES.clear()
            calls.clear()
            base = tpipe.WindowPipeline(apps, policy=pol, backend=backend, device="cpu")
            want = _sig(base.schedule(reqs, 0.1))
            want_calls, want_keys = list(calls), list(tpipe._TABLES)
            tpipe._TABLES.clear()
            calls.clear()
            pipe = tshard.ShardedWindowPipeline(apps, policy=pol, backend=backend, shard=shard,
                                                device="cpu")
            assert _sig(pipe.schedule(reqs, 0.1)) == want
            assert calls == want_calls and list(tpipe._TABLES) == want_keys
            assert pipe.num_shards() == 1 and pipe.last_shard_stats is None


def test_chain_refuses_a_carry_beyond_shared_memory():
    """The chain keeps its carry in one block's shared memory: a carry past
    it is refused on both routes, under P7."""
    n_w, n_slots = 2, 15_000
    assert shard_ops.chain_smem_bytes(n_w, n_slots) > 227 * 1024
    args = (torch.zeros(n_w, dtype=torch.float64),
            torch.full((n_w, n_slots), -1, dtype=torch.int64),
            torch.ones((n_w, n_slots), dtype=torch.float64), 10.0, False,
            torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=torch.float64), torch.zeros(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="P7"):
        shard_ops.chain(*args)
    small = (args[0], args[1][:, :4].contiguous(), args[2][:, :4].contiguous()) + args[3:]
    t_st, r_st = shard_ops.chain(*small)
    assert t_st.shape == (2, n_w) and r_st[1, 0, 0] == 0


# ------------------------------------------------- the round on the device


def _round_case(seed, slot1, span, m=3, n_w=2, n_ids=5):
    """A round's speculated and validated picks (some validated cells
    changed), pre-states, sizes and an LRU capacity that evicts, as
    ``score_block`` and ``chain`` would hand them to ``accept``."""
    rng = np.random.default_rng([seed, span, int(slot1)])
    k = 1 if slot1 else n_ids
    cells = rng.integers(0, n_w * m, span)
    vcells = cells[1:].copy()
    flip = rng.random(span - 1) < 0.3
    vcells[flip] = (vcells[flip] + 1 + rng.integers(0, n_w * m - 1, flip.sum())) % (n_w * m)

    def picks(c):
        n = len(c)
        f = np.round(rng.uniform(0.0, 0.05, (5, n)) * 1024) / 1024
        f[2] = np.where(rng.random(n) < 0.5, 0.0, f[1])  # resident: no effective swap
        i = np.stack([c, rng.integers(0, 9, n), rng.integers(0, n_ids, n)])
        return torch.as_tensor(f), torch.as_tensor(i)

    t_st = torch.as_tensor(np.round(rng.uniform(0.1, 0.5, (span, n_w)) * 1024) / 1024)
    r_st = np.full((span, n_w, k), -1, dtype=np.int64)
    for j in range(span):
        for w in range(n_w):
            held = rng.permutation(n_ids)[: int(rng.integers(0, k + 1))]
            r_st[j, w, : len(held)] = held
    sizes = torch.as_tensor(np.tile(rng.integers(1, 600, n_ids).astype(np.float64) * 2**20,
                                    (n_w, 1)))
    return picks(cells), picks(vcells) if span > 1 else None, t_st, torch.as_tensor(r_st), sizes


def _old_accept(p, total, span, spec, val, t_st, r_st, sizes, cap, slot1, m, out):
    """The accept and carry step of the sharded rounds as they ran with the
    position on the host: merge the picks, find the first conflict with a
    read-back, write the rows, move the carry with a chain of one."""
    from repro_torch.kernels.shard_round.ref import chain_ref

    kn = min(span, total - p)
    sf, si = spec
    pick = (si[0, :kn], si[2, :kn], sf[1, :kn], sf[2, :kn], sf[3, :kn])
    cell, g, sw, swe, lt = pick
    first = tshard.RANK_INF
    if kn > 1:
        vf, vi = val
        vpick = (vi[0, :kn - 1], vi[2, :kn - 1], vf[1, :kn - 1], vf[2, :kn - 1], vf[3, :kn - 1])
        cell, g, sw, swe, lt = (torch.cat([x[:1], y]) for x, y in zip(pick, vpick))
        first = int(torch.where(cell != pick[0], torch.arange(kn), tshard.RANK_INF).min())
    any_m = first < tshard.RANK_INF
    a = first + 1 if any_m else kn
    wi = cell[:a] // m
    start = t_st[torch.arange(a), wi]
    out[0, p:p + a] = wi.to(torch.float64)
    out[1, p:p + a] = (cell[:a] % m).to(torch.float64)
    out[2, p:p + a] = start
    out[3, p:p + a] = ((start + swe[:a]) + lt[:a]) - start
    k = a - 1
    t_n, r_n = chain_ref(t_st[k], r_st[k], sizes, cap, slot1, wi[k:], g[k:a], sw[k:a],
                         lt[k:a])
    return t_n[1], r_n[1], a, int(any_m)


@pytest.mark.parametrize("slot1", [True, False], ids=["slot1", "lru"])
@pytest.mark.parametrize("span,p,total", [(1, 3, 9), (5, 0, 20), (5, 7, 10), (6, 4, 30),
                                          (6, 25, 30)])
@pytest.mark.parametrize("seed", range(4))
def test_accept_matches_the_host_loop(seed, span, p, total, slot1):
    """``accept``'s plain version (the CPU route of the round on the device)
    against the old loop's accept and carry step: the same first conflict,
    rows, carry, position and counts, on rounds cut by the window's end."""
    m, cap = 3, 900.0 * 2**20
    spec, val, t_st, r_st, sizes = _round_case(seed, slot1, span, m)
    want_out = torch.zeros((4, total), dtype=torch.float64)
    want_t, want_r, a, conflict = _old_accept(p, total, span, spec, val, t_st, r_st, sizes,
                                              cap, slot1, m, want_out)
    out = torch.zeros((4, total), dtype=torch.float64)
    pos = torch.tensor([p])
    stats = torch.tensor([4, 1])
    if span == 1:  # a round of one position moves the carry it was scored on
        t, res = t_st[0].clone(), r_st[0].clone()
        rows_t, rows_r = t[None], res[None]
    else:
        t, res = torch.zeros_like(t_st[0]), torch.zeros_like(r_st[0])
        rows_t, rows_r = t_st, r_st
    shard_ops.accept(pos, total, span, spec, val, rows_t, rows_r, sizes, cap, slot1, t, res, out,
                     stats, m)
    assert torch.equal(out, want_out)
    assert torch.equal(t, want_t) and torch.equal(res, want_r)
    assert int(pos) == p + a and stats.tolist() == [5, 1 + conflict]


def test_a_round_past_the_window_changes_nothing():
    """Every entry of a round enqueued after the position has reached the
    window's end leaves every tensor as it was: ``score_block`` writes no
    column, ``chain`` no state, ``accept`` no row, carry, position or
    count."""
    m, total, span, cap = 3, 12, 4, 900.0 * 2**20
    spec, val, t_st, r_st, sizes = _round_case(0, False, span, m)
    rng = np.random.default_rng(1)
    rows, n_w, k = 6, t_st.shape[1], r_st.shape[2]
    f64 = {"dtype": torch.float64}
    tabs = (torch.as_tensor(rng.uniform(0.5, 1.0, (rows, 1, m))), torch.ones((rows, 1), **f64),
            torch.full((rows, 1), 0.3, **f64), torch.ones(rows, **f64),
            torch.full((rows, n_w, m), 0.01, **f64), torch.zeros(rows, dtype=torch.int64),
            torch.zeros((1, n_w, m), **f64), torch.tensor([[0, 1, 2]]),
            torch.ones((1, m), dtype=torch.bool), torch.tensor([1]),
            torch.arange(n_w * m)[None])
    pos = torch.tensor([total])
    bufs = tuple(x.clone() for x in spec)
    got = shard_ops.score_block(t_st, r_st, False, *tabs, pos=pos, lo=0, hi=span, row0=6,
                                total=total, out=bufs)
    assert all(torch.equal(x, y) for x, y in zip(got, spec))
    t_c, r_c = shard_ops.chain(t_st[0], r_st[0], sizes, cap, False, spec[1][0, :-1],
                               spec[1][2, :-1], spec[0][1, :-1], spec[0][3, :-1], models=m,
                               pos=pos, total=total)
    assert not t_c.any() and not r_c.any()
    out = torch.full((4, total), 7.0, **f64)
    t, res, stats = t_st[0].clone(), r_st[0].clone(), torch.tensor([3, 2])
    shard_ops.accept(pos, total, span, spec, val, t_st, r_st, sizes, cap, False, t, res, out,
                     stats, m)
    assert (out == 7.0).all() and torch.equal(t, t_st[0]) and torch.equal(res, r_st[0])
    assert int(pos) == total and stats.tolist() == [3, 2]


def test_score_block_position_rows_match_the_plain_block():
    """``score_block`` with a position: the rows of [p + lo, p + hi) a block
    holds, scored into their columns, equal the same rows scored as a
    plain block; columns of rows the block does not hold keep their
    values."""
    rng = np.random.default_rng(3)
    rows, n_w, m, k, total = 8, 1, 6, 1, 30
    row0, p, lo, hi = 10, 6, 1, 7  # rows 10..13 of [7, 13)
    t = torch.as_tensor(np.round(rng.uniform(0.1, 0.3, (hi - lo, n_w)) * 1024) / 1024)
    res = torch.as_tensor(rng.integers(0, 18, (hi - lo, n_w, k)))
    f64 = {"dtype": torch.float64}
    tabs = (torch.as_tensor(np.round(rng.uniform(0.5, 1.0, (rows, 1, m)) * 16) / 16),
            torch.ones((rows, 1), **f64), torch.as_tensor(rng.uniform(0.05, 3.0, (rows, 1))),
            torch.ones(rows, **f64), torch.as_tensor(np.round(rng.uniform(0.001, 0.01, (rows, n_w, m))
                                                       * 1024) / 1024),
            torch.as_tensor(rng.integers(0, 3, rows)),
            torch.as_tensor(np.round(rng.uniform(0.0, 0.05, (3, n_w, m)) * 1024) / 1024),
            torch.as_tensor(rng.permutation(18)[:18].reshape(3, m)),
            torch.ones((3, m), dtype=torch.bool), torch.tensor([0, 1, 2]),
            torch.stack([torch.as_tensor(rng.permutation(n_w * m)) for _ in range(3)]))
    out = (torch.full((5, hi - lo), -3.0, **f64), torch.full((3, hi - lo), -3, dtype=torch.int64))
    shard_ops.score_block(t, res, True, *tabs, pos=torch.tensor([p]), lo=lo, hi=hi, row0=row0,
                          total=total, out=out)
    held = slice(row0 - p - lo, hi - lo)  # columns 3..5: rows 10..12
    want = shard_ops.score_block(t[held], res[held], True,
                                 *(x[:3] for x in tabs[:6]), *tabs[6:])
    assert torch.equal(out[0][:, held], want[0]) and torch.equal(out[1][:, held], want[1])
    assert (out[0][:, :held.start] == -3.0).all() and (out[1][:, :held.start] == -3).all()


@pytest.mark.parametrize("chunk", [0, 3])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("pool", [None, "three"], ids=["one-worker", "pool"])
@pytest.mark.parametrize("policy", ["LO-EDF", "SneakPeek"])
def test_rounds_across_devices_merge_exactly(suite, monkeypatch, policy, pool, shards, chunk):
    """The rounds' route for shards on devices other than the first (one
    shard per card): every other shard's device is ``cpu:0``, which differs
    from the first shard's ``cpu``, so its picks are scored into buffers of
    its own and merged into the first device's (rows it holds, or the
    cross-shard pick).  Decisions, ``chunk_stats``, shard stats and
    read-backs equal the blocks' run on one device."""
    apps, sneaks = suite
    reqs = _window(suite, 13, per_app=6)
    workers = _pool(pool) if pool else None
    state = StreamingState(worker_ids=[w.wid for w in workers] if workers else None,
                           memory_capacity_bytes=400 * 2**20)
    pol = tsched.make_policy(policy, pipeline=True, chunk=chunk)
    runs = []
    for mesh in (None, [torch.device("cpu", i % 2) if i % 2 else torch.device("cpu")
                        for i in range(shards)]):
        if mesh is not None:
            monkeypatch.setattr(tshard, "shard_mesh", lambda n, device=None, mesh=mesh: mesh)
        pipe = tshard.ShardedWindowPipeline(apps, policy=pol, workers=workers, shard=shards,
                                            device="cpu")
        got = pipe.schedule(reqs, 0.1, state=state)
        runs.append((_sig(got), got.chunk_stats, pipe.last_shard_stats, pipe.last_read_backs))
    assert mesh[1] != mesh[0]
    assert runs[1] == runs[0]


# ------------------------------------------------- simulation and serving


def _trace(seed, windows=6, per_app=5):
    reqs = []
    for w in range(windows):
        window = tapps.make_requests(list(tapps.APP_SPECS.values()), per_app=per_app,
                                     deadline_std_s=0.05, seed=seed + w, start_rid=100 * w)
        for r in window:
            r.arrival_s += 0.1 * w
            r.deadline_s += 0.1 * w
        reqs += window
    return reqs


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("workers", [None, "three"], ids=["one-worker", "pool"])
@pytest.mark.parametrize("policy", ["LO-EDF", "SneakPeek"])
def test_simulation_shard_matches_pipeline(suite, monkeypatch, policy, workers, chunk):
    """``Simulation(shard=4)`` over six windows: every window's schedule,
    the log and the aggregates equal ``Simulation(pipeline=True)``'s."""
    apps, sneaks = suite
    runs = []
    for kw in ({"pipeline": True}, {"shard": 4}):
        seen = []
        real = tsim.evaluate

        def spy(sched, *args, seen=seen, real=real, **kwargs):
            seen.append(_sig(sched))
            return real(sched, *args, **kwargs)

        monkeypatch.setattr(tsim, "evaluate", spy)
        sim = tsim.Simulation(tsched.make_policy(policy), apps, sneakpeeks=sneaks,
                              short_circuit=True, seed=3, memory_capacity_bytes=400 * 2**20,
                              workers=_pool(workers) if workers else None, chunk=chunk,
                              device="cpu", **kw)
        agg = sim.run(_trace(21))
        log = [{k: v for k, v in row.items() if k != "overhead_s"} for row in sim.log]
        runs.append((seen, log, agg))
        monkeypatch.undo()
    assert runs[1] == runs[0]
    assert isinstance(sim._pipeline, tshard.ShardedWindowPipeline)
    assert sim._pipeline.num_shards() == 4


@pytest.mark.parametrize("chunk,preempt", [(0, False), (4, False), (4, True)])
@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_edge_server_shard_matches_reference(policy, chunk, preempt):
    """``EdgeServer(shard=4, overlap=True)`` with chunked speculation and
    preemption, on three ``SimulatedBackend`` lanes: decisions, records,
    counters and fired faults equal the reference's server on the same
    trace (its fast path, decision-identical to its pipeline)."""
    got = _sim_serve(T_PKG, policy, preempt, False, True, shard=4, chunk=chunk)
    assert got[:4] == closed_loop_reference(policy, preempt, False, True)
    assert isinstance(got[4]._pipeline, tshard.ShardedWindowPipeline)
    assert got[4]._pipeline.num_shards() == 4
    if chunk:
        assert got[4]._pipeline.chunk == chunk


def test_shard_route_reaches_every_entry_point(suite):
    """``shard`` through ``make_policy`` (without ``pipeline=True``),
    ``pipeline_schedule`` and ``schedule_window``: the unsharded
    pipeline's schedule every time."""
    apps, _ = suite
    reqs = _window(suite, 5, per_app=4)
    want = _sig(tsched.make_policy("LO-EDF", pipeline=True).schedule(reqs, apps, 0.1,
                                                                      device="cpu"))
    policy = tsched.make_policy("LO-EDF", shard=2)
    assert not policy.pipeline and policy.shard == 2
    assert _sig(policy.schedule(reqs, apps, 0.1, device="cpu")) == want
    assert _sig(tpipe.pipeline_schedule(tsched.make_policy("LO-EDF"), reqs, apps, 0.1,
                                        shard=3, device="cpu")) == want
    sched, _ = tsched.schedule_window(policy, reqs, apps, 0.1, device="cpu")
    assert _sig(sched) == want
    assert np.isfinite([e.est_start_s for e in sched.sorted_entries()]).all()
