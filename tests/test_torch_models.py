"""The port's language models (repro_torch.models) against the JAX package's.

Both packages compute on identical weights: the JAX ``LM.init(seed)``
tree goes through numpy into the port with
``convert.lm_params_from_arrays``.  Inputs are made with numpy from a
seed.  Everything runs in float32 on the CPU, where the port's attention
takes the plain versions of K3 and K4; the reference computes the same
functions in jnp (chunked online softmax for prefill, one masked softmax
for decode).  Three configurations: reduced tinyllama (4 query heads
over 2 KV heads, G = 2); a GQA variant with 8 query heads over 2 (G = 4)
at a sequence length that is no multiple of the reference's 16-key
chunks; and a variant with every optional layer of the ``attn:mlp``
kind switched on (GeGLU, scaled and tied embeddings, q/k norms,
post-norms, logit soft-capping), as the gemma configs use them; and
gemma-7b at d_model 64 with two heads of 256, the head dim that
``reduced()`` (16) would miss.  Then gemma3-4b's sliding-window layers
with their ring-buffer caches, prefilled past the window and decoded
until the ring wraps twice, and the int8 KV cache.  Then
reduced mamba2-130m (the ``ssd:none`` kind: the SSD mixer, whose chunked
scan takes K5's plain version here, and no FFN), against the reference's
``ssd_scan``, ``ssd_forward``, ``ssd_decode_step`` and ``LM``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import LM as JLM
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import ssd as j_ssd
from repro.models.kvcache import cache_bytes as j_cache_bytes
from repro.serving.backends import weight_bytes as j_weight_bytes
from repro_torch import convert
from repro_torch.configs import ARCHS, ModelConfig
from repro_torch.models import LM
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import ssd as t_ssd
from repro_torch.models.kvcache import cache_bytes
from repro_torch.serving.backends import bucket_capacity, weight_bytes

# Float32 on both sides; the sums of a layer (d_model 64, d_ff 128, up to
# 37 keys) are taken in other orders, and a few layers compound them.
LAYER_TOL = 1e-5
MODEL_TOL = 5e-5

# name -> (architecture whose reduced() config is the base, overrides).
CONFIGS = {
    "reduced": ("tinyllama-1.1b", {}),
    "gqa4-ragged": ("tinyllama-1.1b", {"num_heads": 8, "num_kv_heads": 2}),
    "all-options": ("tinyllama-1.1b",
                    {"activation": "geglu", "embed_scale": True, "tie_embeddings": True,
                     "qk_norm": True, "post_norms": True, "logit_softcap": 30.0}),
    "gemma-d256": ("gemma-7b", {"num_heads": 2, "num_kv_heads": 2, "head_dim": 256,
                                "num_layers": 2}),
}
SEQ = {"reduced": 16, "gqa4-ragged": 37, "all-options": 21, "gemma-d256": 19}


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(name, JAX cfg, JAX LM, JAX params, port cfg, port LM, port params)."""
    arch, overrides = CONFIGS[request.param]
    jcfg = dataclasses.replace(J_ARCHS[arch].reduced(), **overrides)
    jlm = JLM(jcfg)
    jparams = jlm.init(seed=3)
    cfg = _port_cfg(jcfg)
    params = convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return request.param, jcfg, jlm, jparams, cfg, LM(cfg), params


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _stacked_cache(cache, name):
    """The port's per-layer caches stacked as the reference's one period."""
    return torch.stack([layer[name] for layer in cache["layers"]]).numpy()


# ---------------------------------------------------------------- layers


class _Leaves:
    def __init__(self, **kw):
        self.__dict__.update({k: torch.as_tensor(v) for k, v in kw.items()})


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=64).astype(np.float32) * 0.1
    ref = j_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    out = t_layers.rmsnorm(_Leaves(scale=scale), torch.as_tensor(x))
    _close(out, ref, LAYER_TOL)


def test_rope_matches_reference():
    """Split halves (not interleaved), angles in float32, positions as a
    prompt of 200 tokens sees them."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 200, size=(2, 7))
    ref = j_layers.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32))
    out = t_layers.rope(torch.as_tensor(x), torch.as_tensor(pos))
    _close(out, ref, LAYER_TOL)


@pytest.mark.parametrize("activation,gated", [("swiglu", True), ("geglu", True),
                                              ("gelu", False)])
def test_mlp_matches_reference(activation, gated):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = {"w_up": rng.normal(size=(32, 48)) / 6, "w_down": rng.normal(size=(48, 32)) / 7}
    if gated:
        w["w_gate"] = rng.normal(size=(32, 48)) / 6
    w = {k: v.astype(np.float32) for k, v in w.items()}
    ref = j_layers.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), activation)
    out = t_layers.mlp(_Leaves(**w), torch.as_tensor(x), activation)
    _close(out, ref, LAYER_TOL)


# ---------------------------------------------------------------- attention


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("pair", ["reduced", "gqa4-ragged", "gemma-d256"], indirect=True)
def test_attn_forward_matches_reference(pair):
    name, jcfg, _, jparams, cfg, _, params = pair
    x = _x(cfg, 2, SEQ[name], 4)
    jp = jax.tree.map(lambda t: t[1], jparams["blocks"][0]["attn"])  # layer 1
    y_ref, (k_ref, v_ref) = j_attn.attn_forward(jp, jnp.asarray(x), jcfg)
    y, (k, v) = t_attn.attn_forward(params.layers[1].attn, torch.as_tensor(x), cfg)
    _close(y, y_ref, LAYER_TOL)
    _close(k, k_ref, LAYER_TOL)
    _close(v, v_ref, LAYER_TOL)


@pytest.mark.parametrize("pair", ["reduced", "gqa4-ragged", "gemma-d256"], indirect=True)
def test_attn_decode_matches_reference(pair):
    """One token at position 9 against caches whose first 9 slots hold
    random keys: the output, and the new K/V written at slot 9 (in place
    in the port)."""
    name, jcfg, _, jparams, cfg, _, params = pair
    rng = np.random.default_rng(5)
    smax, pos = 20, 9
    shape = (2, smax, cfg.num_kv_heads, cfg.head_dim)
    kc, vc = (np.where(np.arange(smax)[None, :, None, None] < pos,
                       rng.normal(size=shape), 0.0).astype(np.float32) for _ in range(2))
    x = _x(cfg, 2, 1, 6)
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"][0]["attn"])
    y_ref, (kc_ref, vc_ref) = j_attn.attn_decode(
        jp, jnp.asarray(x), (jnp.asarray(kc), jnp.asarray(vc)), jnp.asarray(pos, jnp.int32), jcfg)
    kt, vt = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    y, (k_out, v_out) = t_attn.attn_decode(params.layers[0].attn, torch.as_tensor(x),
                                           (kt, vt), torch.tensor(pos, dtype=torch.int32), cfg)
    assert k_out is kt and v_out is vt  # written in place
    _close(y, y_ref, LAYER_TOL)
    _close(kt, kc_ref, LAYER_TOL)
    _close(vt, vc_ref, LAYER_TOL)


# ---------------------------------------------------------------- LM


def test_lm_forward_matches_reference(pair):
    name, _, jlm, jparams, cfg, lm, params = pair
    tokens = _tokens(cfg, 2, SEQ[name], 7)
    ref, _ = jlm.forward(jparams, jnp.asarray(tokens))
    out = lm.forward(params, torch.as_tensor(tokens))
    _close(out, ref, MODEL_TOL)


def test_lm_prefill_and_decode_match_reference(pair):
    """Prefill logits and caches, then three decode steps fed the same
    tokens: logits, caches and positions agree at every step."""
    name, _, jlm, jparams, cfg, lm, params = pair
    s = SEQ[name]
    tokens = _tokens(cfg, 2, s, 8)
    max_len = s + 4
    logits_ref, cache_ref = jlm.prefill(jparams, jnp.asarray(tokens), max_len=max_len)
    logits, cache = lm.prefill(params, torch.as_tensor(tokens), max_len=max_len)
    _close(logits, logits_ref, MODEL_TOL)
    assert cache["pos"] == int(cache_ref["pos"]) == s
    for kv in ("k", "v"):
        _close(_stacked_cache(cache, kv), cache_ref["blocks"][0][kv], MODEL_TOL)
    step_tokens = _tokens(cfg, 2, 3, 9)
    for t in range(3):
        tok = step_tokens[:, t:t + 1]
        logits_ref, cache_ref = jlm.decode_step(jparams, cache_ref, jnp.asarray(tok))
        logits, cache = lm.decode_step(params, cache, torch.as_tensor(tok))
        _close(logits, logits_ref, MODEL_TOL)
        assert cache["pos"] == int(cache_ref["pos"]) == s + t + 1
        for kv in ("k", "v"):
            _close(_stacked_cache(cache, kv), cache_ref["blocks"][0][kv], MODEL_TOL)


def _decode_into_matches_reference(jlm, jparams, cfg, lm, params, seq, seed, tol):
    """Prefill, then five greedy steps: the reference's ``decode_step``
    loop fed its own argmax against ``decode_into`` on static buffers
    (token buffer, logits buffer, cache written in place)."""
    tokens = _tokens(cfg, 2, seq, seed)
    steps = 5
    logits_ref, cache_ref = jlm.prefill(jparams, jnp.asarray(tokens), max_len=seq + steps)
    logits, cache = lm.prefill(params, torch.as_tensor(tokens), max_len=seq + steps)
    tok_ref = jnp.argmax(logits_ref, axis=-1).astype(jnp.int32)[:, None]
    tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
    out = torch.empty_like(logits)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_ref))
    for t in range(steps):
        logits_ref, cache_ref = jlm.decode_step(jparams, cache_ref, tok_ref)
        tok_ref = jnp.argmax(logits_ref, axis=-1).astype(jnp.int32)[:, None]
        lm.decode_into(params, cache, tok, out)
        _close(out, logits_ref, tol)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_ref), err_msg=f"step {t}")
    assert tok.dtype == torch.int32 and int(cache["pos"]) == seq + steps


@pytest.mark.parametrize("pair", ["reduced", "all-options", "gemma-d256"], indirect=True)
def test_decode_into_matches_reference_decode_loop(pair):
    name, _, jlm, jparams, cfg, lm, params = pair
    _decode_into_matches_reference(jlm, jparams, cfg, lm, params, SEQ[name], 20, MODEL_TOL)


@pytest.mark.parametrize("pair", ["reduced"], indirect=True)
def test_cache_position_is_a_device_int32_advanced_in_place(pair):
    """The position is a 0-dim int32 tensor beside the caches, as the
    reference's; decode advances that same tensor in place."""
    name, _, _, _, cfg, lm, params = pair
    s = SEQ[name]
    _, cache = lm.prefill(params, torch.as_tensor(_tokens(cfg, 2, s, 21)), max_len=s + 2)
    pos = cache["pos"]
    assert isinstance(pos, torch.Tensor) and pos.dim() == 0 and pos.dtype == torch.int32
    assert pos.device == cache["layers"][0]["k"].device and int(pos) == s
    _, cache2 = lm.decode_step(params, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert cache2["pos"] is pos and int(pos) == s + 1
    init = lm.init_cache(2, 8, start_pos=3, device="cpu")
    assert init["pos"].dim() == 0 and init["pos"].dtype == torch.int32 and int(init["pos"]) == 3


@pytest.mark.parametrize("pair", ["reduced", "gqa4-ragged"], indirect=True)
def test_bucketed_capacity_gives_the_same_logits(pair):
    """A cache whose capacity is rounded up to the next multiple of 256 (the
    serving backend's) gives the logits of an exact one, within 1e-6 in
    float32: K4 reads only the valid lengths."""
    name, _, _, _, cfg, lm, params = pair
    s, steps = SEQ[name], 4
    capacity = bucket_capacity(s + steps)
    assert capacity == 256
    tokens = torch.as_tensor(_tokens(cfg, 2, s, 22))
    exact_logits, exact = lm.prefill(params, tokens, max_len=s + steps)
    big_logits, big = lm.prefill(params, tokens, max_len=capacity)
    assert big["layers"][0]["k"].shape[1] == capacity
    _close(big_logits, exact_logits, 1e-6)
    tok = exact_logits.argmax(dim=-1, keepdim=True)
    for _ in range(steps):
        exact_logits, exact = lm.decode_step(params, exact, tok)
        big_logits, big = lm.decode_step(params, big, tok)
        _close(big_logits, exact_logits, 1e-6)
        tok = exact_logits.argmax(dim=-1, keepdim=True)


@pytest.mark.parametrize("pair", ["reduced"], indirect=True)
def test_lm_generate_matches_reference(pair):
    """Greedy tokens equal wherever the top-2 logit margin along the
    reference's path exceeds the tolerance (up to each row's first near
    tie; the margins are read from the port, teacher-forced with the
    reference's tokens, which agree with the reference's logits to
    MODEL_TOL by the test above)."""
    name, _, jlm, jparams, cfg, lm, params = pair
    tokens = _tokens(cfg, 3, SEQ[name], 10)
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
    clear = np.cumprod(np.stack(margins, axis=1) > 2 * MODEL_TOL, axis=1).astype(bool)
    assert clear.any()
    np.testing.assert_array_equal(out[clear], ref[clear])


# ---------------------------------------------------------------- sliding window, int8 cache


def _ref_layer(tree, cfg, i):
    """Layer i's entry of the reference's stacked cache (or params) tree."""
    full = cfg.n_periods * cfg.period
    if i < full:
        return jax.tree.map(lambda t: t[i // cfg.period], tree["blocks"][i % cfg.period])
    return tree["tail"][i - full]


def _ported(jcfg, seed):
    """(JAX LM, its params, port cfg, port LM, the same weights in the port)."""
    jlm = JLM(jcfg)
    jparams = jlm.init(seed=seed)
    cfg = _port_cfg(jcfg)
    params = convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jlm, jparams, cfg, LM(cfg), params


@pytest.fixture(scope="module")
def gemma3_pair():
    """gemma3-4b.reduced(): 13 layers, 5 local (window 16) + 1 global per
    period and one local tail layer; q/k norms, post-norms, local and
    global rope thetas."""
    jcfg = J_ARCHS["gemma3-4b"].reduced()
    assert jcfg.window_size == 16 and jcfg.num_layers == 13
    return _ported(jcfg, seed=4)


def test_gemma3_forward_matches_reference(gemma3_pair):
    """A 40-token sequence, 24 positions past the window: K3's windowed
    path in every local layer."""
    jlm, jparams, cfg, lm, params = gemma3_pair
    tokens = _tokens(cfg, 2, 40, 31)
    ref, _ = jlm.forward(jparams, jnp.asarray(tokens))
    _close(lm.forward(params, torch.as_tensor(tokens)), ref, MODEL_TOL)


@pytest.mark.parametrize("prompt", [21, 9], ids=["past-window", "inside-window"])
def test_gemma3_ring_decode_matches_reference(gemma3_pair, prompt):
    """Prefill, then decode until the rings have wrapped twice (position
    21 or 9 up to 56, slots pos % 16): logits at every step, and the ring
    caches of layers 0 and 12 and the global cache of layer 5, slot for
    slot, after prefill and at the end.  Both sides are fed the
    reference's greedy tokens."""
    jlm, jparams, cfg, lm, params = gemma3_pair
    max_len = 56
    tokens = _tokens(cfg, 2, prompt, 32)
    decode = jax.jit(jlm.decode_step)
    logits_ref, cache_ref = jlm.prefill(jparams, jnp.asarray(tokens), max_len=max_len)
    logits, cache = lm.prefill(params, torch.as_tensor(tokens), max_len=max_len)

    def check_caches():
        for i in (0, 5, 12):
            ref = _ref_layer(cache_ref, cfg, i)
            for name in ("k", "v"):
                assert cache["layers"][i][name].shape == ref[name].shape
                _close(cache["layers"][i][name], ref[name], MODEL_TOL)

    _close(logits, logits_ref, MODEL_TOL)
    assert cache["layers"][0]["k"].shape[1] == 16 and cache["layers"][5]["k"].shape[1] == max_len
    check_caches()
    for step in range(max_len - prompt):
        tok = np.array(jnp.argmax(logits_ref, axis=-1), np.int32)[:, None]
        logits_ref, cache_ref = decode(jparams, cache_ref, jnp.asarray(tok))
        logits, cache = lm.decode_step(params, cache, torch.as_tensor(tok))
        _close(logits, logits_ref, MODEL_TOL)
    assert int(cache["pos"]) == int(cache_ref["pos"]) == max_len
    check_caches()


def test_gemma3_decode_into_matches_reference_decode_loop(gemma3_pair):
    """Greedy ``decode_into`` on static buffers across the ring's first wrap."""
    jlm, jparams, cfg, lm, params = gemma3_pair
    _decode_into_matches_reference(jlm, jparams, cfg, lm, params, 14, 33, MODEL_TOL)


def test_kv_quantize_matches_reference():
    """The same inputs give the same int8 codes and scales, exact ties
    (values at half a step, rounded to even) included."""
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = np.arange(16, dtype=np.float32) - 7.5  # absmax 8.5: codes at .5 steps
    x[0, 0, 0, -1] = 127.0 / 16  # absmax 127/16, scale 1/16: x * 16 lands on ties
    x[0, 0, 0, :8] = np.arange(8, dtype=np.float32) / 32
    x[1, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    from repro.models.blocks import _kv_quant

    codes_ref, scale_ref = _kv_quant(jnp.asarray(x))
    codes, scale = t_attn.kv_quantize(torch.as_tensor(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_ref))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_ref))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma3-4b"])
def test_kv_quant_matches_reference(arch):
    """``kv_quant=True``: prefill and four decode steps.  Logits within
    MODEL_TOL at every step; after prefill the scales within MODEL_TOL and
    the codes equal wherever the unrounded code (from the reference's
    float cache: prefill attends to the unquantised K/V, so the values
    quantised are the float model's) lies more than 1e-3 from a tie."""
    base = J_ARCHS[arch].reduced()
    jlm, jparams, cfg, lm, params = _ported(dataclasses.replace(base, kv_quant=True), seed=5)
    s, steps = 21, 4
    tokens = _tokens(cfg, 2, s, 41)
    logits_ref, cache_ref = jlm.prefill(jparams, jnp.asarray(tokens), max_len=s + steps)
    logits, cache = lm.prefill(params, torch.as_tensor(tokens), max_len=s + steps)
    _close(logits, logits_ref, MODEL_TOL)
    _, float_ref = JLM(base).prefill(jparams, jnp.asarray(tokens), max_len=s + steps)
    compared = 0
    for i in range(cfg.num_layers):
        ref, flt, mine = _ref_layer(cache_ref, cfg, i), _ref_layer(float_ref, cfg, i), \
            cache["layers"][i]
        assert sorted(mine) == ["k", "k_scale", "v", "v_scale"]
        filled = min(s, mine["k"].shape[1])  # slots the prompt wrote
        for name in ("k", "v"):
            assert mine[name].dtype == torch.int8
            _close(mine[name + "_scale"], ref[name + "_scale"], MODEL_TOL)
            unrounded = (np.asarray(flt[name], np.float64)[:, :filled]
                         / np.asarray(ref[name + "_scale"])[:, :filled])
            clear = np.abs(np.abs(unrounded - np.floor(unrounded)) - 0.5) > 1e-3
            np.testing.assert_array_equal(mine[name].numpy()[:, :filled][clear],
                                          np.asarray(ref[name])[:, :filled][clear])
            compared += int(clear.sum())
    assert compared > 0
    for t in range(steps):
        tok = np.array(jnp.argmax(logits_ref, axis=-1), np.int32)[:, None]
        logits_ref, cache_ref = jlm.decode_step(jparams, cache_ref, jnp.asarray(tok))
        logits, cache = lm.decode_step(params, cache, torch.as_tensor(tok))
        _close(logits, logits_ref, MODEL_TOL)


# ---------------------------------------------------------------- sizes and init


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_model_config_copy_matches_reference(arch):
    """The port's copy of ModelConfig counts parameters as the reference's
    does for every architecture, full and reduced."""
    jcfg = J_ARCHS[arch]
    cfg = _port_cfg(jcfg)
    assert cfg == _port_cfg(jcfg) and cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert _port_cfg(jcfg.reduced()) == cfg.reduced()


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_registry_sizes_match_reference(arch, reduced):
    """param_count, weight_bytes (the SwapManager's sizes) and cache_bytes
    equal the reference's for every config the port can run."""
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert cfg.param_count() == jcfg.param_count()
    assert weight_bytes(cfg) == j_weight_bytes(jcfg)
    assert cache_bytes(cfg, 3, 40) == j_cache_bytes(jcfg, 3, 40)
    assert LM(cfg).num_params() == JLM(jcfg).num_params()


def test_lm_init_follows_reference_laws():
    """Shapes of the reference's tree; zeros for norm scales; 0.02 for the
    embedding and head; 1/sqrt(fan-in) otherwise, cut at +-2 sigma;
    deterministic per seed."""
    cfg = ARCHS["tinyllama-1.1b"].reduced()
    jcfg = J_ARCHS["tinyllama-1.1b"].reduced()
    params = LM(cfg).init(seed=0, device="cpu")
    tree = convert.lm_params_to_arrays(params)
    jtree = jax.tree.map(np.asarray, JLM(jcfg).init(seed=0))
    assert (jax.tree.structure(tree) == jax.tree.structure(jtree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    blocks = tree["blocks"][0]
    assert not blocks["pre_norm"]["scale"].any() and not tree["final_norm"]["scale"].any()
    trunc_std = 0.8796  # std of a standard normal cut at +-2
    for leaf, std in ((tree["embed"]["embedding"], 0.02), (tree["lm_head"], 0.02),
                      (blocks["attn"]["wq"], cfg.d_model ** -0.5),
                      (blocks["mlp"]["w_down"], cfg.d_ff ** -0.5)):
        assert np.abs(leaf).max() <= 2 * std * (1 + 1e-6)
        assert abs(leaf.std() / (std * trunc_std) - 1) < 0.05
    again = convert.lm_params_to_arrays(LM(cfg).init(seed=0, device="cpu"))
    other = convert.lm_params_to_arrays(LM(cfg).init(seed=1, device="cpu"))
    np.testing.assert_array_equal(again["lm_head"], tree["lm_head"])
    assert not np.array_equal(other["lm_head"], tree["lm_head"])


def test_lm_params_round_trip(pair):
    _, _, _, jparams, cfg, _, params = pair
    back = convert.lm_params_to_arrays(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_array_equal(a, b)


def test_bf16_config_runs_on_cpu():
    """The declared bf16 dtype reaches weights, activations and caches."""
    cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"].reduced(), dtype="bfloat16")
    lm = LM(cfg)
    params = lm.init(seed=0, device="cpu")
    logits, cache = lm.prefill(params, torch.as_tensor(_tokens(cfg, 2, 9, 11)), max_len=12)
    assert params.lm_head.dtype == torch.bfloat16 and logits.dtype == torch.bfloat16
    assert cache["layers"][0]["k"].dtype == torch.bfloat16
    logits, cache = lm.decode_step(params, cache, torch.zeros((2, 1), dtype=torch.int64))
    assert torch.isfinite(logits.float()).all() and cache["pos"] == 10


def test_unported_layer_kinds_raise():
    """No layer kind of the reference raises any more: SSD with more than
    one group builds, its in_proj and conv widened by the groups' B and C
    (tests/test_torch_ssd_groups.py runs it against the reference); the
    ``ssd:none`` kind runs, and so do the recurrent mixers and MoE FFNs
    (tests/test_torch_mixers.py)."""
    base = ARCHS["tinyllama-1.1b"].reduced()
    for kind, key in (("rglru:mlp", "rec"), ("attn:moe", "moe")):
        cfg = dataclasses.replace(base, pattern=(kind,), window_size=16, lru_width=64,
                                  num_experts=4, moe_d_ff=128)
        assert key in LM(cfg).spec["blocks"][0]
    mamba = ARCHS["mamba2-130m"].reduced()
    grouped = dataclasses.replace(mamba, ssd_ngroups=2)
    spec = LM(grouped).spec["blocks"][0]["ssd"]
    din, n, h = grouped.d_inner, grouped.ssd_state, grouped.ssd_heads
    assert spec["in_proj"].shape[-2:] == (grouped.d_model, 2 * din + 2 * 2 * n + h)
    assert spec["conv_w"].shape[-2:] == (grouped.conv_width, din + 2 * 2 * n)
    assert "ssd" in LM(mamba).spec["blocks"][0]  # the ssd:none kind builds


def test_lm_init_needs_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    lm = LM(ARCHS["tinyllama-1.1b"].reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(1, 8)


# ---------------------------------------------------------------- mamba2 (SSD)

# Float32 on both sides; the SSD state sums 16-wide outer products over up
# to 37 steps and the layers' projections are taken in other orders.
SSD_TOL = 1e-4
MAMBA_SEQ = 21  # no multiple of the reduced config's chunk of 8


@pytest.fixture(scope="module")
def mamba_pair():
    """(JAX cfg, JAX LM, JAX params, port cfg, port LM, port params) for
    reduced mamba2-130m on the reference's weights."""
    jcfg = J_ARCHS["mamba2-130m"].reduced()
    jlm = JLM(jcfg)
    jparams = jlm.init(seed=3)
    cfg = _port_cfg(jcfg)
    params = convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jlm, jparams, cfg, LM(cfg), params


def _scan_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) * 0.5 + 0.1).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, 1, n)).astype(np.float32) * 0.3 for _ in range(2))
    return x, dt, a, bm, cm


@pytest.mark.parametrize("s,chunk", [(37, 16), (21, 8), (64, 16), (5, 8)])
def test_ssd_scan_ragged_matches_reference(s, chunk):
    """Lengths that are no multiple of the chunk, padded with dt = 0 steps:
    y and the final state (the state after the last real step) agree with
    the reference's ssd_scan and with the step-by-step recurrence."""
    x, dt, a, bm, cm = _scan_inputs(2, s, 4, 8, 16, s)
    y_ref, st_ref = j_ssd.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), chunk)
    y, st = t_ssd.ssd_scan(*(torch.as_tensor(v) for v in (x, dt, a, bm, cm)), chunk)
    assert y.shape == (2, s, 4, 8) and st.shape == (2, 4, 8, 16)
    _close(y, y_ref, SSD_TOL)
    _close(st, st_ref, SSD_TOL)
    from repro_torch.kernels.ssd.ref import ssd_sequential_ref

    dA = torch.as_tensor(dt * a)
    xdt = torch.as_tensor(x * dt[..., None])
    y_seq, st_seq = ssd_sequential_ref(xdt, dA, torch.as_tensor(bm[:, :, 0]),
                                       torch.as_tensor(cm[:, :, 0]))
    _close(y, y_seq, SSD_TOL)
    _close(st, st_seq, SSD_TOL)


def test_ssd_scan_bf16_within_the_rounding_difference():
    """bf16 inputs: the reference rounds scores, L and the carried states to
    bf16 inside ssd_scan, K5's plain version keeps them float32 (ROADMAP,
    P3); the outputs agree within the bf16 tolerance of
    tests/test_kernels.py, the port's within float32 of the exact scan."""
    x, dt, a, bm, cm = _scan_inputs(2, 37, 4, 8, 16, 1)
    xb, bb, cb = (jnp.asarray(v, jnp.bfloat16) for v in (x, bm, cm))
    y_ref, st_ref = j_ssd.ssd_scan(xb, jnp.asarray(dt), jnp.asarray(a), bb, cb, 16)
    port = [torch.as_tensor(np.asarray(v, np.float32)).to(torch.bfloat16) for v in (xb, bb, cb)]
    y, st = t_ssd.ssd_scan(port[0], torch.as_tensor(dt), torch.as_tensor(a), port[1], port[2], 16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    _close(y.float(), np.asarray(y_ref, np.float32), 2e-2)
    _close(st, np.asarray(st_ref, np.float32), 2e-2)
    y32, st32 = j_ssd.ssd_scan(*(jnp.asarray(np.asarray(v, np.float32)) for v in (xb,)),
                               jnp.asarray(dt), jnp.asarray(a),
                               *(jnp.asarray(np.asarray(v, np.float32)) for v in (bb, cb)), 16)
    _close(st, st32, SSD_TOL)


def test_ssd_forward_and_decode_match_reference(mamba_pair):
    """The mixer of layer 1: prefill output and cache, then two one-token
    steps whose conv window and state the port writes in place."""
    jcfg, _, jparams, cfg, _, params = mamba_pair
    x = _x(cfg, 2, MAMBA_SEQ, 12)
    jp = jax.tree.map(lambda t: t[1], jparams["blocks"][0]["ssd"])
    y_ref, (conv_ref, st_ref) = j_ssd.ssd_forward(jp, jnp.asarray(x), jcfg)
    y, (conv, st) = t_ssd.ssd_forward(params.layers[1].ssd, torch.as_tensor(x), cfg)
    _close(y, y_ref, SSD_TOL)
    _close(conv, conv_ref, SSD_TOL)
    _close(st, st_ref, SSD_TOL)
    cache_ref = (conv_ref, st_ref)
    for t in range(2):
        xt = _x(cfg, 2, 1, 13 + t)
        y_ref, cache_ref = j_ssd.ssd_decode_step(jp, jnp.asarray(xt), cache_ref, jcfg)
        y, (conv_out, st_out) = t_ssd.ssd_decode_step(params.layers[1].ssd, torch.as_tensor(xt),
                                                      (conv, st), cfg)
        assert conv_out is conv and st_out is st  # written in place
        _close(y, y_ref, SSD_TOL)
        _close(conv, cache_ref[0], SSD_TOL)
        _close(st, cache_ref[1], SSD_TOL)


def test_mamba2_forward_matches_reference(mamba_pair):
    _, jlm, jparams, cfg, lm, params = mamba_pair
    tokens = _tokens(cfg, 2, MAMBA_SEQ, 14)
    ref, _ = jlm.forward(jparams, jnp.asarray(tokens))
    _close(lm.forward(params, torch.as_tensor(tokens)), ref, SSD_TOL)


def test_mamba2_prefill_and_decode_match_reference(mamba_pair):
    """Prefill logits and both caches of every layer, then three decode
    steps fed the same tokens: logits, caches and positions agree."""
    _, jlm, jparams, cfg, lm, params = mamba_pair
    tokens = _tokens(cfg, 2, MAMBA_SEQ, 15)
    max_len = MAMBA_SEQ + 4
    logits_ref, cache_ref = jlm.prefill(jparams, jnp.asarray(tokens), max_len=max_len)
    logits, cache = lm.prefill(params, torch.as_tensor(tokens), max_len=max_len)
    _close(logits, logits_ref, SSD_TOL)
    assert cache["pos"] == int(cache_ref["pos"]) == MAMBA_SEQ
    for name in ("conv", "state"):
        assert cache["layers"][0][name].dtype == torch.float32
        _close(_stacked_cache(cache, name), cache_ref["blocks"][0][name], SSD_TOL)
    step_tokens = _tokens(cfg, 2, 3, 16)
    for t in range(3):
        tok = step_tokens[:, t:t + 1]
        logits_ref, cache_ref = jlm.decode_step(jparams, cache_ref, jnp.asarray(tok))
        logits, cache = lm.decode_step(params, cache, torch.as_tensor(tok))
        _close(logits, logits_ref, SSD_TOL)
        assert cache["pos"] == int(cache_ref["pos"]) == MAMBA_SEQ + t + 1
        for name in ("conv", "state"):
            _close(_stacked_cache(cache, name), cache_ref["blocks"][0][name], SSD_TOL)


def test_mamba2_decode_into_matches_reference_decode_loop(mamba_pair):
    jcfg, jlm, jparams, cfg, lm, params = mamba_pair
    _decode_into_matches_reference(jlm, jparams, cfg, lm, params, MAMBA_SEQ, 23, MODEL_TOL)


def test_mamba2_generate_matches_reference(mamba_pair):
    """Greedy tokens equal wherever the top-2 margin along the reference's
    path exceeds the tolerance (as for the attention configs above)."""
    _, jlm, jparams, cfg, lm, params = mamba_pair
    tokens = _tokens(cfg, 3, MAMBA_SEQ, 17)
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
    clear = np.cumprod(np.stack(margins, axis=1) > 2 * SSD_TOL, axis=1).astype(bool)
    assert clear.any()
    np.testing.assert_array_equal(out[clear], ref[clear])


def test_mamba2_params_round_trip_and_init_laws(mamba_pair):
    """convert carries the mamba2 tree (in_proj, conv_w, conv_b, A_log, D,
    dt_bias, norm_scale, out_proj; tied embeddings, no lm_head) both ways;
    LM.init draws the reference's tree with its laws."""
    _, _, jparams, cfg, _, params = mamba_pair
    jtree = jax.tree.map(np.asarray, jparams)
    back = convert.lm_params_to_arrays(params)
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    assert "lm_head" not in back and params.lm_head is None
    assert sorted(back["blocks"][0]["ssd"]) == sorted(
        ["in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale", "out_proj"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    fresh = convert.lm_params_to_arrays(LM(cfg).init(seed=0, device="cpu"))
    assert jax.tree.structure(fresh) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(jtree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    ssd = fresh["blocks"][0]["ssd"]
    assert (ssd["D"] == 1).all() and not ssd["A_log"].any() and not ssd["dt_bias"].any()
    assert not ssd["conv_b"].any() and not ssd["norm_scale"].any()
    trunc_std = 0.8796  # std of a standard normal cut at +-2
    for leaf, std in ((ssd["conv_w"], 0.02), (ssd["in_proj"], cfg.d_model ** -0.5),
                      (fresh["embed"]["embedding"], 0.02)):
        assert np.abs(leaf).max() <= 2 * std * (1 + 1e-6)
        assert abs(leaf.std() / (std * trunc_std) - 1) < 0.1


def test_mamba2_bf16_runs_on_cpu():
    """The declared bf16 dtype reaches weights, activations and the conv
    cache; the SSD state stays float32."""
    cfg = dataclasses.replace(ARCHS["mamba2-130m"].reduced(), dtype="bfloat16")
    lm = LM(cfg)
    params = lm.init(seed=0, device="cpu")
    logits, cache = lm.prefill(params, torch.as_tensor(_tokens(cfg, 2, 9, 18)), max_len=12)
    assert params.embed.embedding.dtype == torch.bfloat16 and logits.dtype == torch.bfloat16
    assert cache["layers"][0]["conv"].dtype == torch.bfloat16
    assert cache["layers"][0]["state"].dtype == torch.float32
    logits, cache = lm.decode_step(params, cache, torch.zeros((2, 1), dtype=torch.int64))
    assert torch.isfinite(logits.float()).all() and cache["pos"] == 10
    init = lm.init_cache(2, 12, device="cpu")
    assert [sorted(c) for c in init["layers"]] == [["conv", "state"]] * cfg.num_layers
