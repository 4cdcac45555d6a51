"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held here against the Pallas kernels in interpret mode and against their
jnp and numpy references, on the shapes of tests/test_kernels.py (K3 and K4 also at head dim
256): K1
(Eq. 2 utility), K2 (k-NN), K3 (prefill flash attention), K4 (flash
decode) and K5 (the Mamba-2 SSD chunk scan).  The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import shutil

import numpy as np
import pytest
import torch

from repro.core.fastpath import sequential_mean, utility_matrix
from repro.kernels.decode_attention.kernel import decode_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as pallas_flash_attention
from repro.kernels.knn.ops import knn_class_votes, knn_topk
from repro.kernels.ssd.kernel import ssd_pallas
from repro.kernels.ssd.ops import ssd as pallas_ssd
from repro.kernels.ssd.ref import ssd_ref
from repro.kernels.utility.ops import utility_scores as pallas_utility_scores
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels import nvcc
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import (
    chunk_cumsum,
    chunk_scan,
    chunk_scores,
    chunk_states,
    ssd_chunk_ref,
    ssd_sequential_ref,
    state_passing,
)
from repro_torch.kernels.utility import ops as util_ops

PENALTIES = ["step", "linear", "sigmoid", "none"]
KNN_SHAPES = [(16, 256, 8, 5, 3), (37, 700, 16, 1, 4), (128, 512, 32, 8, 6), (5, 40, 4, 5, 2)]
UTILITY_SHAPES = [(7, 3), (64, 5), (300, 8)]
# The sweeps of tests/test_kernels.py: (b, s, hq, hkv, d, window) for K3,
# (b, hkv, g, s, d, window, block_k) for K4; then the same with d = 256,
# the head dim of gemma-7b and gemma3-4b.
FLASH_SHAPES = [(2, 128, 4, 4, 32, 0), (1, 256, 8, 2, 64, 0), (2, 96, 4, 1, 32, 0),
                (1, 256, 4, 2, 32, 64), (1, 130, 2, 2, 16, 32)]
FLASH_SHAPES += [(b, s, hq, hkv, 256, w) for b, s, hq, hkv, _, w in FLASH_SHAPES]
DECODE_SHAPES = [(2, 2, 4, 256, 32, 0, 64), (3, 1, 8, 300, 64, 0, 128),
                 (2, 4, 1, 128, 32, 0, 32), (2, 2, 2, 256, 32, 64, 64)]
DECODE_SHAPES += [(b, hkv, g, s, 256, w, bk) for b, hkv, g, s, _, w, bk in DECODE_SHAPES]
# f32 agrees with the Pallas kernels up to summation order over at most a
# few hundred keys; bf16 as tests/test_kernels.py holds its kernels.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The sweep of tests/test_kernels.py:181, (b, s, h, p, n, chunk), held at
# its tolerance (:192).
SSD_SHAPES = [(2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32), (2, 48, 8, 8, 32, 16)]
SSD_ATOL, SSD_RTOL = 2e-4, 1e-3


def _knn_inputs(q, n, d, k, nc):
    rng = np.random.default_rng([q, n, d, k, nc])
    queries = rng.normal(size=(q, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, nc, n).astype(np.int32)
    return queries, x, y


def _port_knn(queries, x, y, k):
    xt = torch.as_tensor(x)
    return knn_ops.knn_topk(torch.as_tensor(queries), xt, (xt * xt).sum(dim=1),
                            torch.as_tensor(y), k)


# ---------------------------------------------------------------- k-NN (K2)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["pallas", "jnp"])
@pytest.mark.parametrize("q,n,d,k,nc", KNN_SHAPES)
def test_knn_plain_matches_reference(q, n, d, k, nc, use_kernel):
    """Votes identical to knn_pallas (interpret mode) and to the jnp
    oracle; distances within 1e-3."""
    queries, x, y = _knn_inputs(q, n, d, k, nc)
    dist, labels = _port_knn(queries, x, y, k)
    ref_d, _ = knn_topk(queries, x, y, k, use_kernel=use_kernel)
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref_d), atol=1e-3, rtol=0)
    votes = knn_ops.votes_from_labels(labels, nc)
    ref_votes = knn_class_votes(queries, x, y, k, nc, use_kernel=use_kernel)
    np.testing.assert_array_equal(votes.numpy(), np.asarray(ref_votes))
    assert votes.dtype == torch.float64
    assert np.all(votes.numpy().sum(1) == k)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_knn_tie_rule_matches_pallas(k):
    """Every training point has an exact twin with another label: equal
    distances go to the lower training index first, as in knn_pallas.

    Integer-valued features make every distance exact in float32, so the
    ties are ties in every implementation whatever its summation order.
    The set fits one Pallas train block (<= 512 rows): across blocks the
    Pallas merge can let a later index overtake an equal earlier one."""
    rng = np.random.default_rng(11 + k)
    base = rng.integers(-3, 4, size=(150, 6)).astype(np.float32)
    y0 = rng.integers(0, 4, 150).astype(np.int32)
    x = np.concatenate([base, base])
    y = np.concatenate([y0, (y0 + 1) % 4]).astype(np.int32)
    queries = rng.integers(-3, 4, size=(40, 6)).astype(np.float32)
    _, labels = _port_knn(queries, x, y, k)
    _, ref_labels = knn_topk(queries, x, y, k, use_kernel=True)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels).astype(np.int32))


def test_knn_rejects_bad_inputs():
    queries, x, y = _knn_inputs(4, 20, 3, 2, 2)
    xt = torch.as_tensor(x)
    with pytest.raises(TypeError):
        knn_ops.knn_topk(torch.as_tensor(queries, dtype=torch.float64), xt,
                         (xt * xt).sum(1), torch.as_tensor(y), 2)
    with pytest.raises(ValueError):
        knn_ops.knn_topk(torch.as_tensor(queries), xt, (xt * xt).sum(1),
                         torch.as_tensor(y), 21)


# ------------------------------------------------------------- utility (K1)


def _utility_inputs(r, m, penalty):
    rng = np.random.default_rng([r, m, len(penalty)])
    acc = rng.uniform(0, 1, (r, m))
    deadlines = rng.uniform(-0.05, 0.3, r)  # includes past/zero deadlines
    completions = rng.uniform(0.0, 0.6, (r, m))
    return acc, deadlines, completions


def _t(*arrays, dtype=torch.float64):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("r,m", UTILITY_SHAPES)
def test_utility_plain_f32_matches_pallas(penalty, r, m):
    """The f32 plain version against utility_scores_pallas (interpret)."""
    acc, dl, comp = _utility_inputs(r, m, penalty)
    u, means = util_ops.utility_scores(*_t(acc, dl, comp, dtype=torch.float32), penalty)
    uk, mk = pallas_utility_scores(acc, dl, comp, penalty=penalty, use_kernel=True)
    np.testing.assert_allclose(u.numpy(), np.asarray(uk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(means.numpy(), np.asarray(mk), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("penalty", PENALTIES)
def test_utility_plain_broadcast_completions(penalty):
    """(M,) completions shared by every row, as grouped selection passes."""
    rng = np.random.default_rng(4)
    acc = rng.uniform(0, 1, (33, 4))
    dl = rng.uniform(0.01, 0.3, 33)
    comp = rng.uniform(0.0, 0.4, 4)
    u, means = util_ops.utility_scores(*_t(acc, dl, comp, dtype=torch.float32), penalty)
    uk, mk = pallas_utility_scores(acc, dl, comp, penalty=penalty, use_kernel=True)
    np.testing.assert_allclose(u.numpy(), np.asarray(uk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(means.numpy(), np.asarray(mk), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("r,m", UTILITY_SHAPES + [(1, 1), (129, 6)])
def test_utility_plain_f64_bit_exact(penalty, r, m):
    """f64: U bit-identical to the numpy fast path's utility_matrix, means
    bit-identical to sequential_mean — the scheduling path's contract."""
    acc, dl, comp = _utility_inputs(r, m, penalty)
    u, means = util_ops.utility_scores(*_t(acc, dl, comp), penalty)
    u_np = utility_matrix(acc, dl[:, None], comp, penalty, backend="numpy")
    np.testing.assert_array_equal(u.numpy(), u_np)
    np.testing.assert_array_equal(means.numpy(), sequential_mean(u_np, axis=0))
    row = comp[0]
    u_row, means_row = util_ops.utility_scores(*_t(acc, dl, row), penalty)
    u_np_row = utility_matrix(acc, dl[:, None], row[None, :], penalty, backend="numpy")
    np.testing.assert_array_equal(u_row.numpy(), u_np_row)
    np.testing.assert_array_equal(means_row.numpy(), sequential_mean(u_np_row, axis=0))


def test_utility_without_means_and_bad_inputs():
    acc, dl, comp = _utility_inputs(9, 2, "linear")
    u, means = util_ops.utility_scores(*_t(acc, dl, comp), "linear", with_means=False)
    assert means is None and u.shape == (9, 2)
    with pytest.raises(ValueError):
        util_ops.utility_scores(*_t(acc, dl, comp), "quadratic")
    with pytest.raises(ValueError):
        util_ops.utility_scores(*_t(acc, dl[:5], comp), "linear")
    with pytest.raises(TypeError):
        a, d, e = _t(acc, dl, comp)
        util_ops.utility_scores(a, d, e.float(), "linear")


# ------------------------------------------------ prefill attention (K3)


def _as_jnp(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _port(x, dtype):
    return torch.as_tensor(np.array(x, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,window", FLASH_SHAPES)
def test_flash_plain_matches_pallas(b, s, hq, hkv, d, window, dtype):
    """The plain version against flash_attention_pallas (interpret mode),
    model layout in and out, on the inputs rounded to ``dtype``."""
    rng = np.random.default_rng([b, s, hq, hkv, d, window])
    q, k, v = (rng.normal(size=(b, s, h, d)) for h in (hq, hkv, hkv))
    ref = pallas_flash_attention(*(_as_jnp(x, dtype) for x in (q, k, v)), window=window,
                                 interpret=True, use_kernel=True)
    out = flash_ops.flash_attention(*(_port(_as_jnp(x, dtype), dtype) for x in (q, k, v)),
                                    window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, s, hq, d)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# causal=False (kernel.py:65-68): the five configurations of
# tests/test_kernels.py:22, then Sq < Skv (37 queries at the last positions
# of 200 keys) without and with a window, as (b, sq, skv, hq, hkv, d, window).
FLASH_FULL_SHAPES = [(b, s, s, hq, hkv, d, w) for b, s, hq, hkv, d, w in FLASH_SHAPES[:5]]
FLASH_FULL_SHAPES += [(2, 37, 200, 4, 2, 32, 0), (2, 37, 200, 4, 2, 32, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window", FLASH_FULL_SHAPES)
def test_flash_plain_non_causal_matches_pallas(b, sq, skv, hq, hkv, d, window, dtype):
    """causal=False: the plain version against flash_attention_pallas(...,
    causal=False) in interpret mode, in the kernel's layout, on the inputs
    rounded to ``dtype``: every key visible, the window alone masking."""
    from repro.kernels.flash_attention.kernel import flash_attention_pallas

    rng = np.random.default_rng([b, sq, skv, hq, hkv, d, window, 1])
    q = rng.normal(size=(b, sq, hq, d))
    k, v = rng.normal(size=(b, skv, hkv, d)), rng.normal(size=(b, skv, hkv, d))
    qk = q.reshape(b, sq, hkv, hq // hkv, d).transpose(0, 2, 3, 1, 4)
    ref = flash_attention_pallas(*(_as_jnp(x, dtype) for x in (qk, k.transpose(0, 2, 1, 3),
                                                                 v.transpose(0, 2, 1, 3))),
                                 causal=False, window=window, interpret=True)
    ref = np.asarray(ref, np.float32).transpose(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    out = flash_ops.flash_attention(*(_port(_as_jnp(x, dtype), dtype) for x in (q, k, v)),
                                    causal=False, window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, sq, hq, d)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])
    if window == 0:  # not causal: a later key moves an earlier query's output
        k2 = k.copy()
        k2[:, -1] += 5.0
        moved = flash_ops.flash_attention(*(_port(_as_jnp(x, dtype), dtype) for x in (q, k2, v)),
                                          causal=False)
        assert not torch.equal(moved[:, 0], out[:, 0])


def test_flash_plain_causality():
    """Future keys do not move the output (tests/test_kernels.py:49)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 64, 2, 16)), dtype=torch.float32)
               for _ in range(3))
    out1 = flash_ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 999.0
    v2[:, 40:] = -999.0
    out2 = flash_ops.flash_attention(q, k2, v2)
    np.testing.assert_allclose(out1[:, :40].numpy(), out2[:, :40].numpy(), atol=1e-6)


def test_flash_offset_queries_match_pallas():
    """Sq < Skv: query i sits at position Skv - Sq + i (kernel.py:42)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 5, 4, 16))
    k, v = rng.normal(size=(2, 2, 37, 16)), rng.normal(size=(2, 2, 37, 16))
    qk = q.reshape(2, 5, 2, 2, 16).transpose(0, 2, 3, 1, 4)
    from repro.kernels.flash_attention.kernel import flash_attention_pallas

    ref = flash_attention_pallas(*(_as_jnp(x, "float32") for x in (qk, k, v)),
                                 block_q=16, block_k=16, interpret=True)
    out = flash_ops.flash_attention(torch.as_tensor(q, dtype=torch.float32),
                                    torch.as_tensor(k.transpose(0, 2, 1, 3), dtype=torch.float32),
                                    torch.as_tensor(v.transpose(0, 2, 1, 3), dtype=torch.float32))
    ref = np.asarray(ref).transpose(0, 3, 1, 2, 4).reshape(2, 5, 4, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL["float32"], rtol=TOL["float32"])


# ---------------------------------------------------------- flash decode (K4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hkv,g,s,d,window,block_k", DECODE_SHAPES)
def test_decode_plain_matches_pallas(b, hkv, g, s, d, window, block_k, dtype):
    """The plain version against decode_attention_pallas (interpret mode)
    with per-row lengths, model layout at the wrapper."""
    rng = np.random.default_rng([b, hkv, g, s, d, window])
    q = rng.normal(size=(b, hkv, g, d))
    k, v = rng.normal(size=(b, hkv, s, d)), rng.normal(size=(b, hkv, s, d))
    lengths = rng.integers(max(window, 1), s + 1, size=b).astype(np.int32)
    qj, kj, vj = (_as_jnp(x, dtype) for x in (q, k, v))
    ref = decode_attention_pallas(qj, kj, vj, _as_jnp(lengths, "float32").astype("int32"),
                                  window=window, block_k=block_k)
    out = decode_ops.decode_attention(
        _port(qj, dtype).reshape(b, 1, hkv * g, d),
        _port(kj, dtype).transpose(1, 2).contiguous(),
        _port(vj, dtype).transpose(1, 2).contiguous(),
        torch.as_tensor(lengths), window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, 1, hkv * g, d)
    np.testing.assert_allclose(out.float().numpy().reshape(b, hkv, g, d),
                               np.asarray(ref, np.float32), atol=TOL[dtype], rtol=TOL[dtype])


def test_decode_plain_respects_length_mask():
    """Positions at or past the length do not move the output
    (tests/test_kernels.py:92)."""
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(1, 1, 2, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(1, 64, 1, 16)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(1, 64, 1, 16)), dtype=torch.float32)
    lengths = torch.tensor([32], dtype=torch.int32)
    o1 = decode_ops.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[:, 32:] = 555.0
    v2[:, 32:] = -555.0
    o2 = decode_ops.decode_attention(q, k2, v2, lengths)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6)


def test_attention_wrappers_reject_bad_inputs():
    q = torch.zeros((1, 4, 4, 16))
    kv = torch.zeros((1, 4, 3, 16))
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, kv, kv)  # 4 query heads over 3 KV heads
    with pytest.raises(ValueError):
        flash_ops.flash_attention(torch.zeros((1, 8, 4, 16)), torch.zeros((1, 4, 2, 16)),
                                  torch.zeros((1, 4, 2, 16)))  # Sq > Skv
    full = flash_ops.flash_attention(q, q, q, causal=False)  # runs: every key visible
    torch.testing.assert_close(full, flash_ops._model(flash_ops.flash_attention_ref(
        flash_ops._gqa(q, 4), q.transpose(1, 2), q.transpose(1, 2), causal=False)))
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q, q.double(), q.double())
    cache = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError):
        decode_ops.decode_attention(torch.zeros((2, 1, 4, 16)), cache, cache,
                                    torch.tensor([3, 4]))  # int64 lengths
    with pytest.raises(ValueError):
        decode_ops.decode_attention(torch.zeros((2, 2, 4, 16)), cache, cache,
                                    torch.tensor([3, 4], dtype=torch.int32))


# ------------------------------------------------------- SSD chunk scan (K5)


def _ssd_inputs(b, s, h, p, n):
    """The model-facing inputs of tests/test_kernels.py:185, float32."""
    rng = np.random.default_rng([b, s, h, p, n])
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) * 0.5 + 0.1).astype(np.float32)
    a_log = (rng.normal(size=(h,)) * 0.3).astype(np.float32)
    bm = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    return x, dt, a_log, bm, cm


def _ssd_close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_plain_matches_pallas(b, s, h, p, n, chunk):
    """The wrapper's plain route against ssd_pallas (interpret mode) and
    against the reference's sequential oracle, through the model-facing
    call of both packages: y and the final state."""
    x, dt, a_log, bm, cm = _ssd_inputs(b, s, h, p, n)
    y, state = ssd_ops.ssd(*(torch.as_tensor(v) for v in (x, dt, a_log, bm, cm)), chunk=chunk)
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    yk, sk = pallas_ssd(x, dt, a_log, bm, cm, chunk=chunk, use_kernel=True)
    _ssd_close(y, yk)
    _ssd_close(state, sk)
    yr, sr = pallas_ssd(x, dt, a_log, bm, cm, chunk=chunk, use_kernel=False)
    _ssd_close(y, yr)
    _ssd_close(state, sr)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_sequential_oracle_matches_reference(b, s, h, p, n, chunk):
    """The port's step-by-step oracle against the reference's ssd_ref and
    against the port's chunked plain version, on ssd_pallas's contract."""
    x, dt, a_log, bm, cm = _ssd_inputs(b, s, h, p, n)
    dA = dt * -np.exp(a_log)
    xdt = x * dt[..., None]
    args = [torch.as_tensor(v) for v in (xdt, dA, bm, cm)]
    ys, ss = ssd_sequential_ref(*args)
    yr, sr = ssd_ref(xdt, dA, bm, cm, chunk=chunk)
    _ssd_close(ys, yr)
    _ssd_close(ss, sr)
    yc, sc = ssd_chunk_ref(*args, chunk)
    _ssd_close(yc, ys)
    _ssd_close(sc, ss)
    yk, sk = ssd_pallas(xdt, dA, bm, cm, chunk=chunk, interpret=True)
    _ssd_close(yc, yk)
    _ssd_close(sc, sk)


# Stage cases beyond tests/test_kernels.py's sweep: one chunk (nc = 1) and
# many (nc = 16), at chunks of 8 to 64.
SSD_STAGE_SHAPES = SSD_SHAPES + [(1, 32, 3, 8, 8, 32), (1, 128, 2, 8, 16, 8),
                                 (2, 64, 2, 16, 8, 64)]


def _ssd_stage_args(b, s, h, p, n):
    x, dt, a_log, bm, cm = _ssd_inputs(b, s, h, p, n)
    dA = dt * -np.exp(a_log)
    xdt = x * dt[..., None]
    return xdt, dA, bm, cm


def _compose_stages(xdt, dA, bm, cm, chunk):
    cum = chunk_cumsum(dA, chunk)
    scores = chunk_scores(bm, cm, chunk)
    entering, final_state = state_passing(chunk_states(xdt, bm, cum, chunk), cum)
    return chunk_scan(xdt, cm, scores, cum, entering, chunk), final_state


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_STAGE_SHAPES)
def test_ssd_plain_stages_compose_to_pallas(b, s, h, p, n, chunk):
    """The five plain stages (cumsum, scores, chunk states, state passing,
    chunk scan), composed by hand as the kernel launches them, against
    ssd_pallas in interpret mode and the step-by-step oracle, at the
    tolerance of tests/test_kernels.py:192 (atol 2e-4, rtol 1e-3)."""
    xdt, dA, bm, cm = _ssd_stage_args(b, s, h, p, n)
    args = [torch.as_tensor(v) for v in (xdt, dA, bm, cm)]
    y, state = _compose_stages(*args, chunk)
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    yc, sc = ssd_chunk_ref(*args, chunk)
    assert torch.equal(y, yc) and torch.equal(state, sc)  # one function to its callers
    yk, sk = ssd_pallas(xdt, dA, bm, cm, chunk=chunk, interpret=True)
    _ssd_close(y, yk)
    _ssd_close(state, sk)
    ys, ss = ssd_sequential_ref(*args)
    _ssd_close(y, ys)
    _ssd_close(state, ss)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_STAGE_SHAPES[3:])
def test_ssd_plain_stages_mean_what_they_say(b, s, h, p, n, chunk):
    """Each stage's own output against numpy and the step-by-step oracle:
    cum is numpy's cumsum per chunk, the scores are C.B^T per chunk, the
    state entering chunk c is the oracle's state after c * chunk steps,
    and the last carry is its final state (atol 2e-4, rtol 1e-3)."""
    xdt, dA, bm, cm = _ssd_stage_args(b, s, h, p, n)
    args = [torch.as_tensor(v) for v in (xdt, dA, bm, cm)]
    nc = s // chunk
    cum = chunk_cumsum(args[1], chunk)
    want_cum = np.cumsum(dA.reshape(b, nc, chunk, h), axis=2).transpose(0, 3, 1, 2)
    _ssd_close(cum, want_cum)
    scores = chunk_scores(args[2], args[3], chunk)
    cc, bc = (t.reshape(b, nc, chunk, n).astype(np.float64) for t in (cm, bm))
    _ssd_close(scores, np.einsum("bcln,bcsn->bcls", cc, bc)[:, :, None])  # one group
    entering, final_state = state_passing(chunk_states(args[0], args[2], cum, chunk), cum)
    assert entering.shape == (b, nc, h, p, n)
    assert not bool(entering[:, 0].any())  # nothing enters the first chunk
    for c in range(1, nc):
        _, state_c = ssd_sequential_ref(*(t[:, :c * chunk] for t in args))
        _ssd_close(entering[:, c], state_c)
    _, state = ssd_sequential_ref(*args)
    _ssd_close(final_state, state)


def test_ssd_plain_strong_decay_stays_finite():
    """Decays summing to about -400 over a chunk: L from differences of the
    cumsum, never a quotient of underflowed exponentials."""
    x, dt, a_log, bm, cm = _ssd_inputs(1, 64, 2, 8, 16)
    dt = dt * 8.0
    y, state = ssd_ops.ssd(*(torch.as_tensor(v) for v in (x, dt, a_log, bm, cm)), chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    dA = dt * -np.exp(a_log)
    yr, sr = ssd_ref(x * dt[..., None], dA, bm, cm)
    _ssd_close(y, yr)
    _ssd_close(state, sr)


def test_ssd_wrapper_rejects_bad_inputs():
    x, dt, a_log, bm, cm = (torch.as_tensor(v) for v in _ssd_inputs(1, 32, 2, 8, 16))
    xdt, dA = x * dt[..., None], dt * -torch.exp(a_log)
    before = ssd_ops.counter.count
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_ops.ssd(x, dt, a_log, bm, cm, chunk=12)
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk_scan(xdt, dA[:, :, :1], bm, cm, 16)  # dA has one head
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk_scan(xdt, dA, bm, cm[:, :, :8], 16)  # B and C differ
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk_scan(xdt, dA, bm[:, :16], cm[:, :16], 16)  # B is shorter
    with pytest.raises(ValueError):
        ssd_ops.ssd(x, dt, a_log[:1], bm, cm, chunk=16)  # a_log has one head
    assert ssd_ops.counter.count == before  # the plain route launches nothing


def test_ssd_has_no_fallback_without_cuda():
    """A tensor that is not on the CPU never takes the plain version; on a
    host without the CUDA toolkit the kernel's route raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the card's route is tested in test_torch_cuda.py")
    meta = [torch.empty(shape, device="meta") for shape in
            ((1, 16, 2, 8), (1, 16, 2), (1, 16, 4), (1, 16, 4))]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ssd_ops.ssd_chunk_scan(*meta, 16)
    host = [torch.zeros(t.shape) for t in meta]
    with pytest.raises(ValueError, match="run on CUDA"):
        ssd_ops.ssd_chunk_scan_stages(*host, 16)  # the stages are the kernel's alone
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            nvcc.library("ssd")


# ------------------------------------------------------------ no fallback


def test_no_cpu_fallback_without_cuda():
    """Without a card, every route that would need one raises; the CPU is
    used only when named, and a non-CPU tensor never takes a plain version."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-CUDA refusal is checked elsewhere")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    meta = [torch.empty((3, 2), dtype=torch.float64, device="meta"),
            torch.empty(3, dtype=torch.float64, device="meta"),
            torch.empty(2, dtype=torch.float64, device="meta")]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        util_ops.utility_scores(*meta, "step")
    q = torch.empty((2, 3), device="meta")
    x = torch.empty((5, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        knn_ops.knn_topk(q, x, torch.empty(5, device="meta"),
                         torch.empty(5, dtype=torch.int32, device="meta"), 2)
    qm = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        flash_ops.flash_attention(qm, qm, qm)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        decode_ops.decode_attention(torch.empty((1, 1, 2, 16), device="meta"), qm, qm,
                                    torch.empty(1, dtype=torch.int32, device="meta"))
