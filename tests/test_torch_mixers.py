"""The port's recurrent and sparse mixers against the JAX package's.

The Griffin RG-LRU block (``repro_torch.models.rglru``, its scan through
``kernels/rglru_scan``'s plain version here) and the routed MoE
(``repro_torch.models.moe``) against ``repro.models.rglru`` and
``repro.models.moe``, then whole LMs of the three configs they bring —
recurrentgemma-9b (rglru, rglru, local), llama4-scout-17b-16e (attn:moe,
16 experts) and llama4-maverick-400b-128e (attn:mlp at dense_d_ff,
attn:moe) — at ``.reduced()`` size, on identical weights (the
reference's ``LM.init`` tree carried across with
``convert.lm_params_from_arrays``), float32 on the CPU: forward,
prefill and decode with their caches, greedy generation, and the
registry's sizes and aliases.

Tolerances: 1e-4 for float32.  The reference runs the recurrence as an
``associative_scan`` (its products added in a log-depth order), the port
step by step; the other sums of a layer are taken in other orders too.
Routing is held exactly: the dropped tokens of a capacity-bound MoE are
the same tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs.registry import ALIASES as J_ALIASES
from repro.configs.registry import get_config as j_get_config
from repro.models import LM as JLM
from repro.models import moe as j_moe
from repro.models import rglru as j_rglru
from repro_torch import convert
from repro_torch.configs import ALIASES, ARCHS, ModelConfig, get_config
from repro_torch.models import LM
from repro_torch.models import moe as t_moe
from repro_torch.models import rglru as t_rglru

TOL = 1e-4
NEW = ["recurrentgemma-9b", "llama4-scout-17b-16e", "llama4-maverick-400b-128e"]
SEQ = 21


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _pair(jcfg, seed=3):
    """(JAX LM, JAX params, port cfg, port LM, port params) on one tree."""
    jlm = JLM(jcfg)
    jparams = jlm.init(seed=seed)
    cfg = _port_cfg(jcfg)
    params = convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jlm, jparams, cfg, LM(cfg), params


@pytest.fixture(scope="module", params=NEW)
def lm_pair(request):
    return (request.param,) + _pair(J_ARCHS[request.param].reduced())


@pytest.fixture(scope="module")
def rgemma():
    return _pair(J_ARCHS["recurrentgemma-9b"].reduced())


def _ref_layer_cache(cache_ref, cfg, i):
    """Layer ``i``'s cache in the reference's stacked layout."""
    full = cfg.n_periods * cfg.period
    if i < full:
        return {k: v[i // cfg.period] for k, v in cache_ref["blocks"][i % cfg.period].items()}
    return cache_ref["tail"][i - full]


# ---------------------------------------------------------------- RG-LRU


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
def test_rglru_forward_matches_reference(rgemma, with_h0):
    """The recurrent block of layer 0 over 21 tokens, from a zero state
    and from a carried one (the conv window and h0): output, conv window
    and last state."""
    _, jparams, cfg, _, params = rgemma
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"][0]["rec"])
    x = _x(cfg, 2, SEQ, 1)
    rng = np.random.default_rng(2)
    conv0 = h0 = None
    if with_h0:
        conv0 = rng.normal(size=(2, cfg.conv_width - 1, cfg.lru_width)).astype(np.float32)
        h0 = rng.normal(size=(2, cfg.lru_width)).astype(np.float32)
    y_ref, (conv_ref, h_ref) = j_rglru.rglru_forward(
        jp, jnp.asarray(x), cfg, None if conv0 is None else jnp.asarray(conv0),
        None if h0 is None else jnp.asarray(h0))
    y, (conv, h) = t_rglru.rglru_forward(
        params.layers[0].rec, torch.as_tensor(x), cfg,
        None if conv0 is None else torch.as_tensor(conv0),
        None if h0 is None else torch.as_tensor(h0))
    assert h.dtype == torch.float32
    _close(y, y_ref)
    _close(conv, conv_ref)
    _close(h, h_ref)


def test_rglru_decode_step_matches_reference(rgemma):
    """Prefill 21 tokens, then three one-token steps whose conv window and
    state the port writes in place."""
    _, jparams, cfg, _, params = rgemma
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"][1]["rec"])  # layer 1
    rec = params.layers[1].rec
    x = _x(cfg, 3, SEQ, 3)
    _, cache_ref = j_rglru.rglru_forward(jp, jnp.asarray(x), cfg)
    _, (conv, h) = t_rglru.rglru_forward(rec, torch.as_tensor(x), cfg)
    for t in range(3):
        xt = _x(cfg, 3, 1, 4 + t)
        y_ref, cache_ref = j_rglru.rglru_decode_step(jp, jnp.asarray(xt), cache_ref, cfg)
        y, (conv_out, h_out) = t_rglru.rglru_decode_step(rec, torch.as_tensor(xt), (conv, h),
                                                         cfg)
        assert conv_out is conv and h_out is h  # written in place
        _close(y, y_ref)
        _close(conv, cache_ref[0])
        _close(h, cache_ref[1])


def test_rglru_scan_plain_matches_its_closed_form():
    """The plain scan against the recurrence written out with the reference's
    ``_gates`` (a, b·x per step), bf16 inputs included: y = h * gelu(g)
    rounded to the input's type, h_last float32."""
    from repro_torch.kernels.rglru_scan.ops import rglru_scan

    rng = np.random.default_rng(5)
    b, s, width = 2, 9, 32
    inputs = [rng.normal(size=(b, s, width)).astype(np.float32) for _ in range(2)]
    inputs += [rng.normal(size=width).astype(np.float32) * 0.5 for _ in range(5)]
    h0 = rng.normal(size=(b, width)).astype(np.float32)
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 2e-2)):
        port = [torch.as_tensor(v).to(dtype) for v in inputs]
        u, g, *vecs = [t.float().numpy() for t in port]  # the values the scan reads
        params = dict(zip(("a_gate_w", "a_gate_b", "x_gate_w", "x_gate_b", "Lambda"), vecs))
        a, bx = j_rglru._gates({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(u))
        a, bx = np.asarray(a), np.asarray(bx)
        h = h0.copy()
        hs = np.zeros_like(u)
        for t in range(s):
            h = a[:, t] * h + bx[:, t]
            hs[:, t] = h
        want = hs * np.asarray(jax.nn.gelu(jnp.asarray(g), approximate=True))
        y, h_last = rglru_scan(*port, torch.as_tensor(h0))
        assert y.dtype == dtype and h_last.dtype == torch.float32
        _close(y.float(), want, tol)  # bf16: the output's own rounding
        _close(h_last, h, TOL)
    u, g, *vecs = (torch.as_tensor(v) for v in inputs)
    with pytest.raises(ValueError, match="h0 must be"):
        rglru_scan(u, g, *vecs, torch.zeros(b, width + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("s,chunk", [
    (24, 8),  # chunks that divide S
    (37, 8),  # a last chunk of 5 steps
    (5, 8),  # S below the chunk: one chunk, no summaries
    (1, 8),  # the decode step
    (130, 64),  # the kernel's chunk, a last chunk of 2 steps
])
def test_rglru_scan_chunked_plain_matches_sequential_and_reference(s, chunk, with_h0, dtype):
    """The chunked two-pass order the kernel runs (chunk summaries, the
    carry pushed through them, each chunk scanned again from its carry)
    against the sequential plain scan and against the reference's
    ``_gates`` and ``jax.lax.associative_scan`` (``rglru_forward``'s
    combine, h0 folded into the first step): f32 y within 1e-4, bf16 y
    within 2e-2 (its own rounding), h_last within 1e-4."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_chunked_ref, rglru_scan_ref

    rng = np.random.default_rng([s, chunk, with_h0])
    b, width = 2, 16
    inputs = [rng.normal(size=(b, s, width)).astype(np.float32) for _ in range(2)]
    inputs += [rng.normal(size=width).astype(np.float32) * 0.5 for _ in range(5)]
    h0 = rng.normal(size=(b, width)).astype(np.float32) if with_h0 else None
    port = [torch.as_tensor(v).to(dtype) for v in inputs]
    h0_t = torch.as_tensor(h0) if with_h0 else None
    y, h_last = rglru_scan_chunked_ref(*port, h0_t, chunk=chunk)
    y_seq, h_seq = rglru_scan_ref(*port, h0_t)
    assert y.dtype == dtype and h_last.dtype == torch.float32 and y.shape == (b, s, width)
    tol = TOL if dtype == torch.float32 else 2e-2
    _close(y.float(), y_seq.float(), tol)
    _close(h_last, h_seq, TOL)

    u, g, *vecs = [t.float().numpy() for t in port]  # the values the scan reads
    params = dict(zip(("a_gate_w", "a_gate_b", "x_gate_w", "x_gate_b", "Lambda"), vecs))
    a, bx = j_rglru._gates({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(u))
    if with_h0:
        bx = bx.at[:, 0, :].add(a[:, 0, :] * jnp.asarray(h0))
    _, hs = jax.lax.associative_scan(
        lambda left, right: (left[0] * right[0], right[0] * left[1] + right[1]), (a, bx),
        axis=1)
    want = np.asarray(hs) * np.asarray(jax.nn.gelu(jnp.asarray(g), approximate=True))
    _close(y.float(), want, tol)
    _close(h_last, np.asarray(hs)[:, -1], TOL)


# ---------------------------------------------------------------- MoE


def _moe_case(arch, **overrides):
    jcfg = dataclasses.replace(J_ARCHS[arch].reduced(), **overrides)
    jlm, jparams, cfg, _, params = _pair(jcfg, seed=7)
    layer = next(i for i in range(cfg.num_layers) if cfg.layer_kind(i).endswith(":moe"))
    full = cfg.n_periods * cfg.period
    jp = jax.tree.map(lambda t: t[layer // cfg.period],
                      jparams["blocks"][layer % cfg.period]["moe"]) if layer < full else \
        jparams["tail"][layer - full]["moe"]
    return jcfg, cfg, jp, params.layers[layer].moe


@pytest.mark.parametrize("case", ["scout", "maverick", "drops-top2", "drops-no-shared"])
def test_moe_forward_matches_reference(case):
    """Outputs and the Switch aux term: drop-free (the reduced configs'
    capacity factor), and capacity-bound with top-k = 2 (``fill`` carried
    across the two rounds) or top-1 without the shared expert, 64 tokens
    in groups of 16."""
    arch, overrides = {
        "scout": ("llama4-scout-17b-16e", {}),
        "maverick": ("llama4-maverick-400b-128e", {}),
        "drops-top2": ("llama4-scout-17b-16e", {"moe_top_k": 2, "capacity_factor": 0.5}),
        "drops-no-shared": ("llama4-scout-17b-16e", {"capacity_factor": 0.5,
                                                     "shared_expert": False}),
    }[case]
    jcfg, cfg, jp, moe = _moe_case(arch, **overrides)
    x = _x(cfg, 4, 16, 9) * 3.0
    y_ref, aux_ref = j_moe.moe_forward(jp, jnp.asarray(x), jcfg)
    y, aux = t_moe.moe_forward(moe, torch.as_tensor(x), cfg)
    _close(y, y_ref)
    _close(aux, aux_ref)
    if case == "drops-no-shared":
        # Routing is identical: exactly the reference's dropped tokens
        # (all-zero rows: no expert, no shared MLP) are dropped here.
        dropped_ref = np.all(np.asarray(y_ref) == 0.0, axis=-1)
        assert 0 < dropped_ref.sum() < dropped_ref.size
        np.testing.assert_array_equal(np.all(y.numpy() == 0.0, axis=-1), dropped_ref)


def test_moe_routes_take_capacity_in_token_order():
    """The port's routing rule on a hand-made case: with capacity 4 the
    fifth token for one expert is dropped, and the second round continues
    each expert's buffer where the first left it."""
    probs = torch.tensor([[[0.7, 0.2, 0.1]] * 5 + [[0.1, 0.6, 0.3]]])
    routes = t_moe._routes(probs, 2, 4)
    eidx, pos, keep, gate = routes[0]
    assert eidx.tolist() == [[0, 0, 0, 0, 0, 1]]
    assert pos.tolist() == [[0, 1, 2, 3, 4, 0]]
    assert keep.tolist() == [[True] * 4 + [False, True]]
    assert gate[0, 4] == 0.0
    eidx2, pos2, keep2, _ = routes[1]
    assert eidx2.tolist() == [[1, 1, 1, 1, 1, 2]]
    assert pos2.tolist() == [[1, 2, 3, 4, 5, 0]]  # expert 1 holds one token already
    assert keep2.tolist() == [[True, True, True, False, False, True]]
    assert t_moe._capacity(16, 1, 4, 4.0) == j_moe._capacity(16, 1, 4, 4.0)
    assert t_moe._capacity(512, 1, 128, 1.25) == j_moe._capacity(512, 1, 128, 1.25) == 8


def test_moe_refuses_a_ragged_group():
    jcfg, cfg, _, moe = _moe_case("llama4-scout-17b-16e")
    with pytest.raises(ValueError, match="not divisible by moe_group"):
        t_moe.moe_forward(moe, torch.zeros((3, 7, cfg.d_model)), cfg)


def test_serving_pads_a_moe_batch_to_whole_groups():
    """The routed layers refuse a batch whose B·S tokens leave a partial
    group, as the reference's do; the serving backend right-pads such a
    batch to whole groups of ``moe_group`` with zero tokens, so it serves
    the same tokens as the batch padded by hand."""
    from repro_torch.serving.backends import ProfiledBackend, moe_group_len

    cfg = ARCHS["llama4-scout-17b-16e"].reduced()
    assert cfg.moe_group == 16
    assert moe_group_len(cfg, 3, 7) == 16 and moe_group_len(cfg, 8, 5) == 6
    assert moe_group_len(cfg, 2, 5) == 5  # ten tokens: one group
    assert moe_group_len(ARCHS["recurrentgemma-9b"].reduced(), 3, 7) == 7
    backend = ProfiledBackend({"scout": (cfg, 3)}, new_tokens=3, device="cpu")
    prompts = _tokens(cfg, 3, 7, 5)
    lm, params = backend._get("scout")
    with pytest.raises(ValueError, match="not divisible by moe_group"):
        lm.prefill(params, torch.as_tensor(prompts), max_len=16)
    got = backend.run_batch("scout", prompts, [0, 1, 2])
    padded = np.zeros((3, 16), np.int32)
    padded[:, :7] = prompts
    want = backend.run_batch("scout", padded, [0, 1, 2])
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.shape == (3, 3)


# ---------------------------------------------------------------- whole LMs


def test_lm_forward_matches_reference(lm_pair):
    _, jlm, jparams, cfg, lm, params = lm_pair
    tokens = _tokens(cfg, 2, 32, 11)
    ref, _ = jlm.forward(jparams, jnp.asarray(tokens))
    _close(lm.forward(params, torch.as_tensor(tokens)), ref)


def test_lm_prefill_and_decode_match_reference(lm_pair):
    """Prefill logits and every layer's cache (attention K/V or ring, RG-LRU
    conv window and state), then three decode steps fed the same tokens:
    logits, caches and positions agree at every step.  Batch 2 x 24
    tokens is three MoE groups of 16 at prefill and one group of 2 a
    decode step."""
    _, jlm, jparams, cfg, lm, params = lm_pair
    s = 24
    tokens = _tokens(cfg, 2, s, 12)
    logits_ref, cache_ref = jlm.prefill(jparams, jnp.asarray(tokens), max_len=s + 4)
    logits, cache = lm.prefill(params, torch.as_tensor(tokens), max_len=s + 4)
    _close(logits, logits_ref)

    def check_caches():
        for i, layer in enumerate(cache["layers"]):
            ref = _ref_layer_cache(cache_ref, cfg, i)
            assert set(layer) == set(ref)
            for name, t in layer.items():
                _close(t, ref[name])

    check_caches()
    step_tokens = _tokens(cfg, 2, 3, 13)
    for t in range(3):
        tok = step_tokens[:, t:t + 1]
        logits_ref, cache_ref = jlm.decode_step(jparams, cache_ref, jnp.asarray(tok))
        logits, cache = lm.decode_step(params, cache, torch.as_tensor(tok))
        _close(logits, logits_ref)
        assert cache["pos"] == int(cache_ref["pos"]) == s + t + 1
        check_caches()


def test_lm_generate_matches_reference(lm_pair):
    """Greedy tokens equal wherever the top-2 logit margin along the
    reference's path exceeds the tolerance (as in
    tests/test_torch_models.py)."""
    _, jlm, jparams, cfg, lm, params = lm_pair
    tokens = _tokens(cfg, 2, 16, 14)
    steps = 5
    ref = np.asarray(jlm.generate(jparams, jnp.asarray(tokens), steps))
    out = lm.generate(params, torch.as_tensor(tokens), steps).numpy()
    logits, cache = lm.prefill(params, torch.as_tensor(tokens), max_len=tokens.shape[1] + steps)
    margins = []
    for t in range(steps):
        top2 = torch.sort(logits, dim=-1).values[:, -2:].numpy()
        margins.append(top2[:, 1] - top2[:, 0])
        if t < steps - 1:
            logits, cache = lm.decode_step(params, cache, torch.as_tensor(ref[:, t:t + 1].copy()))
    clear = np.cumprod(np.stack(margins, axis=1) > 2 * TOL, axis=1).astype(bool)
    assert clear.any()
    np.testing.assert_array_equal(out[clear], ref[clear])


def test_lm_params_round_trip(lm_pair):
    """convert carries the ``rec`` and ``moe`` trees (shared expert, gated
    experts, router) both ways."""
    name, _, jparams, cfg, _, params = lm_pair
    back = convert.lm_params_to_arrays(params)
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    key = "rec" if name == "recurrentgemma-9b" else "moe"
    assert any(key in blk for blk in back["blocks"])


def test_maverick_dense_layers_take_dense_d_ff():
    cfg = ARCHS["llama4-maverick-400b-128e"]
    spec = LM(cfg.reduced()).spec
    assert spec["blocks"][0]["mlp"]["w_up"].shape[-1] == cfg.reduced().dense_d_ff
    assert "moe" in spec["blocks"][1] and "mlp" not in spec["blocks"][1]
    assert cfg.dense_d_ff == 16384 and cfg.moe_d_ff == 8192


# ---------------------------------------------------------------- registry


def test_registry_holds_the_reference_configs_and_aliases():
    """All ten configs, equal to the reference's, and its ``ALIASES``."""
    assert sorted(ARCHS) == sorted(J_ARCHS) and len(ARCHS) == 10
    for name, cfg in ARCHS.items():
        assert cfg == _port_cfg(J_ARCHS[name])
    assert ALIASES == J_ALIASES
    for alias in ALIASES:
        assert get_config(alias) == _port_cfg(j_get_config(alias))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama5")
