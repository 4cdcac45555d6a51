"""The arithmetic of the two backward kernels' tensor-core designs, on the CPU.

K3b's bf16 instance (``kernels/flash_attention/csrc/flash_attention_bwd.cu``)
runs its products on the tensor cores with bf16 operands, so p and dS are
rounded to bf16 where they become a product's operand, as
FlashAttention-2 does (ROADMAP, queue 3, P10); the reference keeps them
in fp32.  K5b (``kernels/ssd/csrc/ssd_bwd.cu``) runs every product as
three TF32 passes of an error-compensated split (3xTF32), which must keep
fp32 accuracy (fault P3).  Neither kernel runs here, so each test
emulates the kernel's rounding in plain numpy or PyTorch and holds the
emulation against the reference: (a) ``jax.vjp`` of the JAX package's
``flash_attention`` on bf16 inputs, at the card tests' bf16 tolerance
(2e-2); (b) the float64 product, within K5b's tolerance (atol 2e-4,
rtol 1e-3), where one TF32 pass is not.  (c) K3's and K3b's float32
instances run every product as K5b does (3xTF32); their plain versions
emulate it (``rounding="tf32x3"``), held against
``flash_attention_pallas`` in interpret mode and against ``jax.vjp`` of
the reference's ``flash_attention`` on float32 inputs at the card tests'
float32 tolerance (2e-5).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    split_tf32,
)

ATTN_BF16_TOL = 2e-2  # tests/test_torch_cuda.py's ATTN_TOL for bfloat16
ATTN_F32_TOL = 2e-5  # and for float32
SSD_ATOL, SSD_RTOL = 2e-4, 1e-3  # K5b's, tests/test_torch_cuda.py


# ---------------------------------------------------------------- (a) K3b's bf16 rounding


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _k3b_emulated(q, k, v, do, window, rounding="bf16"):
    """dq, dk, dv of causal GQA attention in K3b's bf16 arithmetic: the
    forward's o (rounded to bf16, as K3 writes it) and logsumexp in fp32;
    with ``rounding`` "bf16" (the D <= 128 design), p and dS rounded to
    bf16 before the products that take them; with "bf16x2" (D = 256), dS
    so and p taken to dV's product as two bf16 terms, its rounding and what
    that rounding left; with None, nothing rounded; every sum in fp32.
    q, do (B, S, Hq, D), k, v (B, S, Hkv, D), float32 holding the inputs'
    values; gradients in float32."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    rounded = rounding is not None
    rnd = _bf16 if rounded else (lambda t: t)
    rnd_p = (lambda t: _bf16(t) + _bf16(t - _bf16(t))) if rounding == "bf16x2" else rnd
    qh, doh = q.permute(0, 2, 1, 3), do.permute(0, 2, 1, 3)  # (B, Hq, S, D)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    pos = torch.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    sc = (qh @ kh.transpose(-1, -2)) * scale
    sc = sc.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(sc, dim=-1, keepdim=True)
    p = torch.exp(sc - lse)
    o = _bf16(p @ vh) if rounded else p @ vh
    drow = (doh * o).sum(-1, keepdim=True)
    dv = rnd_p(p).transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - drow) * scale
    dq = rnd(ds) @ kh
    dk = rnd(ds).transpose(-1, -2) @ qh
    dk = dk.reshape(b, hkv, g, s, d).sum(2)
    dv = dv.reshape(b, hkv, g, s, d).sum(2)
    return dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, s, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, hkv, d)).astype(np.float32) for _ in range(2))
    # The inputs' values as bf16 holds them, so both sides see the same numbers.
    return [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v, do)]


@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    (1, 256, 8, 1, 64, 0),    # tinyllama's G = 8 at D = 64
    (1, 128, 16, 2, 128, 0),  # G = 8 at D = 128 (32-row tiles in the kernel)
    (2, 256, 8, 1, 64, 48),   # a window that is not a multiple of a tile
    (1, 128, 2, 2, 256, 0),   # D = 256, G = 1 (gemma-7b's MHA)
    (1, 128, 16, 1, 256, 48),  # D = 256, G = 16 with a window (recurrentgemma-9b's local)
])
def test_k3b_bf16_rounding_matches_reference_vjp(b, s, hq, hkv, d, window):
    """K3b's bf16 arithmetic (p and dS rounded to bf16 as operands; at D =
    256 p as two bf16 terms) against ``jax.vjp`` of the reference's
    ``flash_attention`` on bf16 inputs (its custom VJP keeps p and dS in
    fp32), within 2e-2."""
    q, k, v, do = _inputs(b, s, hq, hkv, d, [b, s, hq, d, window])
    chunk = max(s // 4, 16)

    def ref(q, k, v):
        return j_attn.flash_attention(q, k, v, causal=True, window=window, q_chunk=chunk,
                                      kv_chunk=chunk)

    _, vjp = jax.vjp(ref, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    got = _k3b_emulated(*(torch.as_tensor(x) for x in (q, k, v, do)), window,
                        "bf16x2" if d == 256 else "bf16")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert w.dtype == jnp.bfloat16, name
        np.testing.assert_allclose(_bf16(g).numpy(), np.asarray(w, np.float32),
                                   atol=ATTN_BF16_TOL, rtol=ATTN_BF16_TOL, err_msg=name)


def test_k3b_emulation_without_rounding_is_the_plain_backward():
    """With the bf16 rounding taken out, the emulation is K3b's plain
    version (``flash_attention_bwd_ref``) to fp32 rounding: the emulation
    computes the kernel's function, and only its rounding differs."""
    b, s, hq, hkv, d, window = 2, 96, 6, 2, 32, 40
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(b, s, hq, hkv, d, 5))
    got = _k3b_emulated(q, k, v, do, window, rounding=None)
    qg, dog = (t.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4) for t in (q, do))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    o, lse = flash_attention_ref(qg, kt, vt, window=window, return_lse=True)
    dq, dk, dv = flash_attention_bwd_ref(qg, kt, vt, o, dog, lse, window=window)
    want = (dq.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d), dk.transpose(1, 2),
            dv.transpose(1, 2))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5, msg=name)


@pytest.mark.parametrize("rounding", ["bf16", "bf16x2"])
def test_plain_backward_rounding_is_the_emulation(rounding):
    """``flash_attention_bwd_ref(rounding=...)``, which the card's probe
    holds K3b's bf16 instances against, does this file's emulation of
    their arithmetic, given the emulation's forward output and logsumexp:
    equal but for fp32 summation order, which can move a bf16 rounding of
    p or dS by one step (1e-3 allows a few such steps)."""
    b, s, hq, hkv, d, window = 1, 96, 8, 1, 64, 40
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(b, s, hq, hkv, d, 7))
    got = _k3b_emulated(q, k, v, do, window, rounding)
    qg, dog = (t.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4) for t in (q, do))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    o, lse = flash_attention_ref(qg, kt, vt, window=window, return_lse=True)
    dq, dk, dv = flash_attention_bwd_ref(qg, kt, vt, _bf16(o), dog, lse, window=window,
                                         rounding=rounding)
    want = (dq.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d), dk.transpose(1, 2),
            dv.transpose(1, 2))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3, msg=name)
    with pytest.raises(ValueError):
        flash_attention_bwd_ref(qg, kt, vt, o, dog, lse, rounding="fp8")


def test_plain_backward_in_float64_agrees_with_float32():
    """Given float64 inputs, ``flash_attention_bwd_ref`` works in float64
    (the card's probe uses it as the exact side of K3b's fp32 instance):
    within float32 rounding of the float32 run on the same values."""
    b, s, hq, hkv, d, window = 2, 80, 4, 2, 32, 0
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(b, s, hq, hkv, d, 11))
    qg, dog = (t.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4) for t in (q, do))
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    o, lse = flash_attention_ref(qg, kt, vt, window=window, return_lse=True)
    single = flash_attention_bwd_ref(qg, kt, vt, o, dog, lse, window=window)
    double = flash_attention_bwd_ref(*(t.double() for t in (qg, kt, vt, o, dog, lse)),
                                     window=window)
    for name, x, y in zip(("dq", "dk", "dv"), single, double):
        assert y.dtype == torch.float64, name
        torch.testing.assert_close(x.double(), y, atol=2e-5, rtol=2e-5, msg=name)


# ---------------------------------------------------------------- (b) K5b's 3xTF32 products


def _tf32(x):
    """float32 -> the nearest TF32 value, ties away from zero: what
    ``cvt.rna.tf32.f32`` gives (10 explicit mantissa bits, the low 13
    bits of the float32 cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32((x - hi).astype(np.float32))


def _mm_3xtf32(a, b):
    """K5b's ``mm_tile``: a_lo b_hi + a_hi b_lo, then a_hi b_hi, each
    product exact in fp32 (11 by 11 significant bits), summed in fp32."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _stage_operands(depth, kind, seed):
    """A (64, depth) and B (depth, 64) as a K5b stage draws them: decays
    exp(cum_i - cum_j) in (0, 1] on the scores of 0.3-scaled B and C rows
    (dx, dscores), or the decays e_i on C's rows against dy (dstate), or dy
    against an entering state grown over chunks (dbc)."""
    rng = np.random.default_rng(seed)
    if kind == "scores":
        n = 128
        bm, cm = (rng.normal(size=(depth, n)).astype(np.float32) * 0.3 for _ in range(2))
        dt = np.abs(rng.normal(size=depth)) * 0.5 + 0.1
        cum = np.cumsum(-dt * np.exp(rng.normal() * 0.3))
        lower = np.arange(depth)[:, None] >= np.arange(depth)[None, :]
        decay = np.where(lower, np.exp(np.minimum(cum[:, None] - cum[None, :], 0.0)), 0.0)
        a = ((cm @ bm.T) * decay)[:64].astype(np.float32)
        b = rng.normal(size=(depth, 64)).astype(np.float32)
    elif kind == "decays":
        e = np.exp(np.cumsum(-(np.abs(rng.normal(size=depth)) * 0.05)))
        a = (rng.normal(size=(64, depth)) * 0.3 * e[None, :]).astype(np.float32)
        b = rng.normal(size=(depth, 64)).astype(np.float32)
    else:  # "state": dy against an entering state, a sum of chunk states
        a = rng.normal(size=(64, depth)).astype(np.float32)
        b = (rng.normal(size=(depth, 64)) * 0.3 * np.sqrt(depth)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("kind", ["scores", "decays", "state"])
@pytest.mark.parametrize("depth", [64, 128])
def test_k5b_3xtf32_product_keeps_fp32_accuracy(depth, kind):
    """The emulated 3xTF32 product within K5b's tolerance of the float64
    product (atol 2e-4, rtol 1e-3), and within 100 times fp32's own error;
    one TF32 pass misses both by far (the split is what fault P3 needs)."""
    a, b = _stage_operands(depth, kind, [depth, len(kind)])
    exact = a.astype(np.float64) @ b.astype(np.float64)
    split = _mm_3xtf32(a, b)
    fp32_err = np.abs(a @ b - exact).max()
    split_err = np.abs(split - exact).max()
    np.testing.assert_allclose(split, exact, atol=SSD_ATOL, rtol=SSD_RTOL)
    assert split_err <= 100 * max(fp32_err, np.finfo(np.float32).eps * np.abs(exact).max())
    one_pass_err = np.abs(_tf32(a) @ _tf32(b) - exact).max()
    print(f"{kind} depth {depth}: max |d| from float64: 3xTF32 {split_err:.3g}, fp32 "
          f"{fp32_err:.3g}, one TF32 pass {one_pass_err:.3g}")
    assert one_pass_err > 20 * split_err, (one_pass_err, split_err)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """``_tf32`` rounds to 10 mantissa bits, to nearest, ties away from zero
    (``cvt.rna``), and the split reconstructs x to within 2^-21 |x|."""
    one_ulp = 2.0 ** -10
    x = np.array([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                  1.0 + 3 * one_ulp / 4], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp],
                           np.float32))
    y = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    hi, lo = _split(y)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - y) <= 2.0 ** -21 * np.abs(y))


# ---------------------------------------------------------------- (c) K3's and K3b's 3xTF32


def test_plain_tf32_split_is_cvt_rna():
    """``ref.split_tf32``, which the plain versions' ``rounding="tf32x3"``
    splits every operand with, is K5b's emulated split bit for bit
    (``_tf32``: ``cvt.rna.tf32.f32``), ties and signs included."""
    one_ulp = 2.0 ** -10
    x = np.concatenate([
        np.array([0.0, -0.0, 1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                  3e-39, -7e30], np.float32),
        np.random.default_rng(1).normal(size=4096).astype(np.float32) * 10.0])
    hi, lo = split_tf32(torch.as_tensor(x))
    want_hi, want_lo = _split(x)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))


@pytest.mark.parametrize("depth", [16, 64, 256])
def test_plain_tf32x3_product_is_k5b_product(depth):
    """The plain versions' product with ``rounding="tf32x3"`` is
    ``_mm_3xtf32`` (K5b's three passes) up to float32 summation order,
    and within 100 times fp32's own error of the float64 product, where
    one TF32 pass is not."""
    from repro_torch.kernels.flash_attention.ref import _product

    rng = np.random.default_rng(depth)
    a = rng.normal(size=(64, depth)).astype(np.float32)
    b = rng.normal(size=(64, depth)).astype(np.float32)
    got = _product("qd,kd->qk", torch.as_tensor(a), torch.as_tensor(b), "tf32x3").numpy()
    exact = a.astype(np.float64) @ b.T.astype(np.float64)
    np.testing.assert_allclose(got, _mm_3xtf32(a, b.T), atol=1e-5, rtol=1e-6)
    err = np.abs(got - exact).max()
    assert err <= 100 * np.abs(a @ b.T - exact).max()
    assert np.abs(_tf32(a) @ _tf32(b.T) - exact).max() > 20 * err
    with pytest.raises(ValueError):
        flash_attention_ref(*(torch.zeros((1, 1, 1, 4, 16)) for _ in range(1)),
                            torch.zeros((1, 1, 4, 16)), torch.zeros((1, 1, 4, 16)),
                            rounding="bf16")


# (b, sq, skv, hq, hkv, d, window): every head dim, G = 1, 2 and 16, windows,
# Sq < Skv and lengths off a multiple of the kernels' tiles; the G = 16,
# D = 256 cases are recurrentgemma-9b's local layers (16 over 1, windowed).
TF32X3_CASES = [
    (2, 64, 64, 2, 2, 16, 0), (1, 100, 100, 4, 2, 32, 24), (1, 96, 160, 8, 4, 64, 0),
    (1, 130, 130, 16, 1, 64, 0), (1, 70, 70, 4, 2, 128, 32), (1, 40, 90, 2, 1, 128, 0),
    (1, 130, 130, 16, 1, 256, 48), (1, 77, 77, 2, 2, 256, 0), (1, 45, 150, 16, 1, 256, 0),
]


def _f32_inputs(b, sq, skv, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, sq, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _kernel_layout(q, hkv):
    b, s, hq, d = q.shape
    return q.reshape(b, s, hkv, hq // hkv, d).transpose(0, 2, 3, 1, 4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window", TF32X3_CASES)
def test_k3_tf32x3_matches_pallas(b, sq, skv, hq, hkv, d, window, causal):
    """K3's float32 arithmetic (``flash_attention_ref(rounding="tf32x3")``:
    Q.K^T and P.V as three TF32 products of the split operands) against
    ``flash_attention_pallas`` in interpret mode on float32 inputs, within
    2e-5, causal and not; ``rounding=None`` stays the plain float32
    version."""
    q, k, v, _ = _f32_inputs(b, sq, skv, hq, hkv, d, [b, sq, skv, hq, d, window, causal])
    qk = _kernel_layout(q, hkv)
    kt, vt = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    want = np.asarray(flash_attention_pallas(jnp.asarray(qk), jnp.asarray(kt), jnp.asarray(vt),
                                             causal=causal, window=window, interpret=True))
    args = (torch.as_tensor(qk), torch.as_tensor(kt), torch.as_tensor(vt))
    got = flash_attention_ref(*args, causal=causal, window=window, rounding="tf32x3")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_F32_TOL, rtol=ATTN_F32_TOL)
    plain = flash_attention_ref(*args, causal=causal, window=window)
    assert torch.equal(plain, flash_attention_ref(*args, causal=causal, window=window,
                                                  rounding=None))
    np.testing.assert_allclose(plain.numpy(), want, atol=ATTN_F32_TOL, rtol=ATTN_F32_TOL)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window", TF32X3_CASES)
def test_k3b_tf32x3_matches_reference_vjp(b, sq, skv, hq, hkv, d, window):
    """K3b's float32 arithmetic (``flash_attention_bwd_ref(rounding=
    "tf32x3")``: S, dP, dV, dK and dQ as three TF32 products of the split
    operands, on the emulated forward's output and logsumexp) against
    ``jax.vjp`` of the reference's ``flash_attention`` on float32 inputs,
    within 2e-5."""
    q, k, v, do = _f32_inputs(b, sq, skv, hq, hkv, d, [b, sq, skv, hq, d, window, 2])
    # With Sq < Skv the reference puts query i at Skv - Sq + i only when
    # neither axis is padded to its chunk: chunks that divide both.
    chunk = max(sq // 4, 16) if sq == skv else math.gcd(sq, skv)

    def ref(q, k, v):
        return j_attn.flash_attention(q, k, v, causal=True, window=window, q_chunk=chunk,
                                      kv_chunk=chunk)

    _, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    qg, dog = (torch.as_tensor(_kernel_layout(x, hkv)) for x in (q, do))
    kt, vt = (torch.as_tensor(x.transpose(0, 2, 1, 3)) for x in (k, v))
    o, lse = flash_attention_ref(qg, kt, vt, window=window, return_lse=True, rounding="tf32x3")
    dq, dk, dv = flash_attention_bwd_ref(qg, kt, vt, o, dog, lse, window=window,
                                         rounding="tf32x3")
    got = (dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d), dk.transpose(1, 2),
           dv.transpose(1, 2))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert w.dtype == jnp.float32 and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_F32_TOL,
                                   rtol=ATTN_F32_TOL, err_msg=name)
    with pytest.raises(ValueError):
        flash_attention_bwd_ref(*(t.double() for t in (qg, kt, vt, o, dog, lse)),
                                window=window, rounding="tf32x3")


def test_reference_offset_holds_only_without_uneven_padding():
    """Pins ROADMAP §3, C6: with Sq < Skv the reference's ``flash_attention``
    places query i at Skv - Sq + i only when its chunks pad neither axis
    (or both alike); chunks of 24 pad 160 keys by 8 and 96 queries by
    none, and its output leaves the plain version (which the Pallas
    kernel matches) by far more than float32 rounding."""
    b, sq, skv, hq, hkv, d = 1, 96, 160, 8, 4, 64
    q, k, v, _ = _f32_inputs(b, sq, skv, hq, hkv, d, 6)
    plain = flash_attention_ref(torch.as_tensor(_kernel_layout(q, hkv)),
                                torch.as_tensor(k.transpose(0, 2, 1, 3)),
                                torch.as_tensor(v.transpose(0, 2, 1, 3)))
    plain = plain.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).numpy()
    for chunk, right in ((32, True), (24, False)):
        got = np.asarray(j_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                q_chunk=chunk, kv_chunk=chunk))
        err = np.abs(got - plain).max()
        assert (err < ATTN_F32_TOL) == right, (chunk, err)
        if not right:
            assert err > 0.1, err
