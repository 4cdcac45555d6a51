"""The port's serving plane (repro_torch.serving) against the JAX package's.

The same application, request trace, SneakPeek training set and model
weights go through the reference's ``EdgeServer`` (``LMExecutor`` over
its ``ProfiledBackend``) and the port's, on the CPU (``device="cpu"``):
the served statistics must be equal (mean utility bit for bit), every
executed batch must hold the same requests on the same model, and the
generated tokens must be equal wherever the reference's top-2 logit
margin exceeds the tolerance.  The weights are the reference's
``LM.init(seed)``, carried into the port's backend with
``convert.lm_params_from_arrays``.  Two assistants: two tinyllama
variants, and two families, reduced mamba2-130m (the SSD mixer, its scan
through K5's plain version) beside reduced tinyllama-1.1b.  Also checked:
the swap manager, the options the port does not have yet, and the CUDA
rule of the entry points.  The multi-worker pool is held in
tests/test_torch_pool.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.core import Application as JApplication
from repro.core import ModelProfile as JModelProfile
from repro.core import Request as JRequest
from repro.core import make_policy as j_make_policy
from repro.core.sneakpeek import KNNSneakPeek as JKNNSneakPeek
from repro.serving import EdgeServer as JEdgeServer
from repro.serving import LMExecutor as JLMExecutor
from repro.serving.runtime import SwapManager as JSwapManager
from repro_torch import convert
from repro_torch.configs import ModelConfig
from repro_torch.core.accuracy import ModelProfile
from repro_torch.core.scheduler import make_policy
from repro_torch.core.sneakpeek import KNNSneakPeek
from repro_torch.core.types import Application, Request
from repro_torch.serving.backends import ProfiledBackend
from repro_torch.serving.runtime import LMExecutor, SwapManager
from repro_torch.serving.server import EdgeServer

NEW_TOKENS = 3
# Float32 logits of a few layers, summed in other orders (as in
# tests/test_torch_models.py).
TOKEN_TOL = 1e-4
FEATURE_DIM = 8
_BASE = J_ARCHS["tinyllama-1.1b"].reduced()
J_VARIANTS = {
    "tiny-small": (_BASE, 0),
    "tiny-large": (dataclasses.replace(_BASE, num_layers=3), 1),
}
PROFILES = [("tiny-small", [0.72, 0.70], 0.010, 0.02), ("tiny-large", [0.84, 0.82], 0.030, 0.06)]
# The two families of examples/edge_serving.py, with its recalls.
J_FAMILIES = {
    "mamba2-130m": (J_ARCHS["mamba2-130m"].reduced(), 0),
    "tinyllama-1.1b": (_BASE, 1),
}
FAMILY_PROFILES = [("mamba2-130m", [0.72, 0.70], 0.010, 0.02),
                   ("tinyllama-1.1b", [0.84, 0.82], 0.030, 0.06)]
# The three families of examples/edge_serving.py, gemma-7b with its
# recalls; reduced gemma-7b keeps GeGLU, the scaled tied embedding and MHA.
J_THREE = dict(J_FAMILIES, **{"gemma-7b": (J_ARCHS["gemma-7b"].reduced(), 2)})
# Its profile makes both policies pick it for some requests and mamba2-130m
# for others on this trace (tinyllama-1.1b is offered and never chosen).
THREE_PROFILES = FAMILY_PROFILES + [("gemma-7b", [0.94, 0.92], 0.035, 0.03)]


def _port_variants(variants=J_VARIANTS):
    return {name: (ModelConfig(**dataclasses.asdict(cfg)), seed)
            for name, (cfg, seed) in variants.items()}


def _apps(profile_cls, app_cls, profiles=PROFILES):
    models = [profile_cls(n, recalls=r, latency_s=lat, load_latency_s=load)
              for n, r, lat, load in profiles]
    return {"assistant": app_cls(name="assistant", models=models, penalty="sigmoid")}


def _features(rng, labels):
    centres = np.stack([np.full(FEATURE_DIM, -0.6), np.full(FEATURE_DIM, 0.6)])
    return (centres[labels] + rng.normal(size=(len(labels), FEATURE_DIM))).astype(np.float32)


def _trace(request_cls, n=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    feats = _features(rng, labels)
    slack = rng.choice([0.2, 0.5, 1.0], size=n)
    return [request_cls(rid=i, app="assistant", arrival_s=0.01 * i,
                        deadline_s=0.01 * i + float(slack[i]), features=feats[i],
                        true_label=int(labels[i]))
            for i in range(n)]


def prompt_fn(req):
    """Seeded per request; two prompt lengths, so batches are right-padded."""
    length = 8 if req.rid % 3 else 12
    return np.random.default_rng(req.rid).integers(0, _BASE.vocab_size, length).astype(np.int32)


@pytest.fixture(scope="module")
def knn_split():
    rng = np.random.default_rng(7)
    y = rng.integers(0, 2, 400).astype(np.int32)
    return _features(rng, y), y


def _executors(variants=J_VARIANTS):
    """(reference executor, port executor) serving identical weights."""
    jexec = JLMExecutor(variants, new_tokens=NEW_TOKENS)
    backend = ProfiledBackend(_port_variants(variants), new_tokens=NEW_TOKENS, device="cpu")
    for name in variants:
        _, jparams = jexec.backend._get(name)
        backend.set_params(name, convert.lm_params_from_arrays(
            backend.variants[name][0], jax.tree.map(np.asarray, jparams), device="cpu"))
    return jexec, LMExecutor(backend=backend)


def _margins(jexec, report, prompts=None):
    """The reference's top-2 logit margins (B, new_tokens) along its own
    greedy tokens, from its backend's compiled prefill and decode steps;
    the prompts are the report's requests' unless given."""
    backend = jexec.backend
    _, params = backend._get(report.model)
    if prompts is None:
        prompts = JLMExecutor._pad([_Entry(rid) for rid in report.request_ids], prompt_fn)
    logits, cache = backend._prefill_jit[report.model](params, prompts)
    out = []
    for t in range(NEW_TOKENS):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
        if t < NEW_TOKENS - 1:
            logits, cache = backend._decode_jit[report.model](
                params, cache, report.tokens[:, t:t + 1])
    return np.stack(out, axis=1)


class _Entry:
    def __init__(self, rid):
        self.request = JRequest(rid=rid, app="assistant", arrival_s=0.0, deadline_s=0.0)


def _serve_both(policy, knn_split, variants, profiles):
    """Serve the trace through both servers: (jexec, jouts, jstats, touts, tstats)."""
    x, y = knn_split
    jexec, texec = _executors(variants)
    jsneaks = tsneaks = None
    if policy == "SneakPeek":
        jsneaks = {"assistant": JKNNSneakPeek(x, y, 2, k=5, backend="numpy")}
        tsneaks = {"assistant": KNNSneakPeek(x, y, 2, k=5, device="cpu")}
    with JEdgeServer(_apps(JModelProfile, JApplication, profiles), j_make_policy(policy),
                     executor=jexec, sneakpeeks=jsneaks, prompt_fn=prompt_fn) as jsrv:
        jouts, jstats = jsrv.run(_trace(JRequest))
    tsrv = EdgeServer(_apps(ModelProfile, Application, profiles), make_policy(policy),
                      executor=texec, sneakpeeks=tsneaks, prompt_fn=prompt_fn, device="cpu")
    touts, tstats = tsrv.run(_trace(Request))
    return jexec, jouts, jstats, touts, tstats


def _check_served(jexec, jouts, jstats, touts, tstats, variants, used=None):
    """Equal statistics, the same batches on the same models (``used``, all
    the variants unless given), and equal tokens wherever the reference's
    top-2 margin clears the tolerance."""
    for key in ("windows", "requests", "violations", "swaps"):
        assert getattr(tstats, key) == getattr(jstats, key), key
    assert tstats.mean_utility == jstats.mean_utility
    assert tstats.worker_busy_s == jstats.worker_busy_s
    assert tstats.profile_provenance == jstats.profile_provenance
    jreports = [r for o in jouts for r in o["reports"]]
    treports = [r for o in touts for r in o["reports"]]
    assert len(treports) == len(jreports) > 1
    assert {r.model for r in treports} == set(variants if used is None else used)
    compared = 0
    for tr, jr in zip(treports, jreports):
        assert (tr.request_ids, tr.model, tr.batch_size, tr.swap_s) == \
            (jr.request_ids, jr.model, jr.batch_size, jr.swap_s)
        assert tr.tokens.shape == jr.tokens.shape == (jr.batch_size, NEW_TOKENS)
        clear = np.cumprod(_margins(jexec, jr) > TOKEN_TOL, axis=1).astype(bool)
        np.testing.assert_array_equal(tr.tokens[clear], jr.tokens[clear])
        compared += int(clear.sum())
    assert compared > 0


@pytest.mark.parametrize("policy", ["Grouped", "SneakPeek"])
def test_edge_server_matches_reference(policy, knn_split):
    _check_served(*_serve_both(policy, knn_split, J_VARIANTS, PROFILES), J_VARIANTS)


@pytest.mark.parametrize("policy", ["Grouped", "SneakPeek"])
def test_edge_server_two_families_match_reference(policy, knn_split):
    """Reduced mamba2-130m beside reduced tinyllama-1.1b: both families
    serve batches, and the statistics equal the reference's."""
    _check_served(*_serve_both(policy, knn_split, J_FAMILIES, FAMILY_PROFILES), J_FAMILIES)


@pytest.mark.parametrize("policy", ["Grouped", "SneakPeek"])
def test_edge_server_three_families_match_reference(policy, knn_split):
    """Reduced gemma-7b offered beside reduced mamba2-130m and
    tinyllama-1.1b: the statistics and every decision equal the
    reference's, and gemma-7b serves batches."""
    _check_served(*_serve_both(policy, knn_split, J_THREE, THREE_PROFILES), J_THREE,
                  used={"gemma-7b", "mamba2-130m"})


def test_lm_executor_matches_reference():
    """One padded batch through both executors: swap charges, timing
    fields and greedy tokens; class predictions from the option logits."""
    jexec, texec = _executors()
    entries = [_Entry(rid) for rid in (3, 4, 5)]
    prompts = JLMExecutor._pad(entries, prompt_fn)
    np.testing.assert_array_equal(LMExecutor._pad(entries, prompt_fn), prompts)
    ids = np.array([5, 17, 101])
    for name in ("tiny-large", "tiny-small", "tiny-large"):
        jr = jexec.run_batch(name, prompts, [3, 4, 5], ids)
        tr = texec.run_batch(name, prompts, [3, 4, 5], ids)
        assert tr.swap_s == jr.swap_s and tr.batch_size == 3
        assert tr.prefill_s > 0 and tr.decode_s > 0
        clear = np.cumprod(_margins(jexec, jr) > TOKEN_TOL, axis=1).astype(bool)
        np.testing.assert_array_equal(tr.tokens[clear], jr.tokens[clear])
        assert [int(p) for p in tr.predictions] == [int(p) for p in jr.predictions]
    assert texec.swaps.swap_count == jexec.swaps.swap_count == 2
    for name in J_VARIANTS:
        assert texec.backend.model_bytes(name) == jexec.backend.model_bytes(name)
        assert texec.backend.swap_cost(name) == jexec.backend.swap_cost(name)
        assert texec.backend.profile(name, [0.5, 0.5]).provenance == "profiled"


def test_backend_shares_decode_buffers_across_ragged_batches():
    """Decode buffers are keyed by (variant, batch size, capacity rounded up
    to a multiple of 256) for attention, by (variant, batch size) for SSD,
    whose caches do not grow: prompts of 8 and 12 tokens share one key,
    one of 300 takes the next; the tokens equal the reference's wherever
    its top-2 margin clears the tolerance."""
    jexec, texec = _executors(J_FAMILIES)
    rng = np.random.default_rng(3)
    compared = 0
    for name in J_FAMILIES:
        for s in (8, 12, 300):
            prompts = rng.integers(0, _BASE.vocab_size, (2, s)).astype(np.int32)
            jr = jexec.backend.run_batch(name, prompts, [0, 1])
            tr = texec.backend.run_batch(name, prompts, [0, 1])
            assert tr.tokens.shape == jr.tokens.shape == (2, NEW_TOKENS)
            clear = np.cumprod(_margins(jexec, jr, prompts) > TOKEN_TOL, axis=1).astype(bool)
            np.testing.assert_array_equal(tr.tokens[clear], jr.tokens[clear])
            compared += int(clear.sum())
    assert compared > 0
    assert sorted(texec.backend._decoders, key=str) == sorted(
        [("mamba2-130m", 2, None), ("tinyllama-1.1b", 2, 256), ("tinyllama-1.1b", 2, 512)],
        key=str)
    assert texec.backend.graph_stats() == {"graphs": 0, "captures": 0, "replays": 0,
                                           "capture_s": 0.0}  # eager on the host


def test_backend_shares_one_cache_per_capacity():
    """The decode buffers of one (variant, capacity) decode on the leading
    rows of one cache, made at the largest batch size the variant has
    decoded: a batch of 3 after one of 2 makes a 3-row cache and retires
    the 2-row key, which is made again on the new cache; batches of 1
    start on it too, and a batch of 1 at a new capacity makes a 3-row
    cache at once, so a later batch of 3 there retires nothing.  A model
    without attention gives each batch size a cache of its own.  Tokens
    equal the reference's wherever its top-2 margin clears the
    tolerance."""
    jexec, texec = _executors(J_FAMILIES)
    backend = texec.backend
    rng = np.random.default_rng(4)
    compared = 0
    for name in J_FAMILIES:
        for b, s in ((2, 9), (3, 9), (2, 9), (1, 9), (1, 300), (3, 300)):
            prompts = rng.integers(0, _BASE.vocab_size, (b, s)).astype(np.int32)
            jr = jexec.backend.run_batch(name, prompts, list(range(b)))
            tr = backend.run_batch(name, prompts, list(range(b)))
            clear = np.cumprod(_margins(jexec, jr, prompts) > TOKEN_TOL, axis=1).astype(bool)
            np.testing.assert_array_equal(tr.tokens[clear], jr.tokens[clear])
            compared += int(clear.sum())
    assert compared > 0
    for cap in (256, 512):
        rows, layers, _ = backend._caches[("tinyllama-1.1b", cap)]
        assert rows == 3
        for b in ((1, 2, 3) if cap == 256 else (1, 3)):
            dec = backend._decoders[("tinyllama-1.1b", b, cap)]
            for mine, shared in zip(dec.cache["layers"], layers):
                for n, t in mine.items():
                    assert t.data_ptr() == shared[n].data_ptr() and t.shape[0] == b
    assert backend.graph_stats() == {"graphs": 0, "captures": 0, "replays": 0,
                                     "capture_s": 0.0}
    assert set(backend._caches) == {("tinyllama-1.1b", 256), ("tinyllama-1.1b", 512)}
    ptrs = set()
    for b in (1, 2, 3):
        layer = backend._decoders[("mamba2-130m", b, None)].cache["layers"][0]
        assert all(t.shape[0] == b for t in layer.values())
        ptrs.update(t.data_ptr() for t in layer.values())
    assert len(ptrs) == 3 * len(layer)


def test_swap_manager_matches_reference():
    """LRU residency under a byte capacity: the same charges and evictions."""
    sizes = {"a": 5, "b": 4, "c": 3, "d": 9}
    loads = {"a": 0.5, "b": 0.4, "c": 0.3, "d": 0.9}
    seq = ["a", "b", "a", "c", "d", "b", "b", "a", "c", "d", "d", "a"]
    for capacity in (None, 8, 12):
        j, t = JSwapManager(capacity, sizes, loads), SwapManager(capacity, sizes, loads)
        for name in seq:
            assert t.load(name) == j.load(name)
            assert t.resident_bytes() == j.resident_bytes()
        assert (t.swap_count, t.evictions) == (j.swap_count, j.evictions)


@pytest.mark.parametrize("option,value", [("pipeline", True), ("chunk", 4), ("shard", True)])
def test_unported_server_options_raise(option, value):
    """``pipeline=True``, its speculative chunked selection (``chunk``) and
    sharding (``shard``, ROADMAP item 11) are ported
    (tests/test_torch_pipeline.py, tests/test_torch_shard.py): the server
    keeps one pipeline, sharded when ``shard`` is given, alone or beside
    the others."""
    from repro_torch.core.shard import ShardedWindowPipeline
    from repro_torch.serving import server as tserver

    apps = _apps(ModelProfile, Application)
    kwargs = {option: value, **({"chunk": 4} if option == "pipeline" else {})}
    if option != "shard":
        srv = EdgeServer(apps, make_policy("Grouped"), device="cpu", **kwargs)
        assert srv._pipeline is None or srv._pipeline.chunk == 4
        kwargs["shard"] = True
    srv = EdgeServer(apps, make_policy("Grouped"), device="cpu", **kwargs)
    assert isinstance(srv._pipeline, ShardedWindowPipeline)
    assert srv._pipeline.num_shards() == 1 and srv._pipeline.chunk == kwargs.get("chunk")
    assert not hasattr(tserver, "NOT_PORTED")


def test_serving_entry_points_need_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from repro_torch.core.multiworker import Worker
    from repro_torch.serving.backends import CompiledBackend
    from repro_torch.serving.runtime import ExecutorPool, WorkerExecutor

    calls = [
        lambda: ProfiledBackend(_port_variants()),
        lambda: CompiledBackend(_port_variants()),
        lambda: LMExecutor(_port_variants()),
        lambda: WorkerExecutor(Worker(0), _port_variants()),
        lambda: ExecutorPool([Worker(0), Worker(1)], _port_variants()),
        lambda: EdgeServer(_apps(ModelProfile, Application), make_policy("Grouped")),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
