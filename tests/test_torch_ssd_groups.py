"""The Mamba-2 SSD with several groups (``ssd_ngroups`` > 1) in the port
against the reference, on the CPU.

B and C are (B, S, G, N), shared by the H / G heads of a group, head h
reading group h // (H / G), as the reference's ``ssd_scan``
(src/repro/models/ssd.py:83), ``ssd_forward`` and ``ssd_decode_step``
take them.  ``ssd_pallas`` takes one group, so the reference's jnp scan
is the oracle here.  At G = 2 and G = 4 on reduced mamba2-130m's widths
(H = 16 heads of 8, N = 16, chunks of 8): the port's ``ssd_scan``
through K5's plain version, and its gradients through the autograd
function's plain backward (K5b's) against ``jax.grad``; a reduced
mamba2 ``LM`` on the reference's weights, prefill and three decode
steps; the per-stage plain functions against a loop over the groups;
the fake branch's scratch and FLOPs.  One training gradient per group
count is in tests/test_torch_training_grads.py, and the sharded steps
in tests/test_torch_dryrun.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import LM as JLM
from repro.models import ssd as j_ssd
from repro_torch import convert, kernels
from repro_torch.configs import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import (
    chunk_cumsum,
    chunk_scan,
    chunk_scores,
    chunk_states,
    ssd_chunk_bwd_ref,
    ssd_chunk_ref_saving,
    ssd_sequential_ref,
    state_passing,
)
from repro_torch.models import LM
from repro_torch.models import ssd as t_ssd

# f32 on both sides: the scan agrees within 1e-4 (P3), as
# tests/test_torch_models.py holds mamba2; gradients as
# tests/test_torch_training.py holds the one-group scan's.
SSD_TOL = 1e-4
GROUPS = [2, 4]
H, P, N, CHUNK = 16, 8, 16, 8  # reduced mamba2-130m: d_inner 128 in heads of 8
SEQ = 21  # no multiple of the chunk


def _inputs(b, s, g, seed):
    rng = np.random.default_rng([b, s, g, seed])
    x = rng.normal(size=(b, s, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, H))) * 0.5 + 0.1).astype(np.float32)
    a = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, g, N)).astype(np.float32) * 0.3 for _ in range(2))
    return x, dt, a, bm, cm


def _close(a, b, tol=SSD_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("s", [SEQ, 32])
@pytest.mark.parametrize("g", GROUPS)
def test_grouped_ssd_scan_matches_reference(g, s):
    """The port's ``ssd_scan`` (K5's plain version) against the reference's,
    y and the final state, and against the step-by-step recurrence with
    each head reading its group."""
    x, dt, a, bm, cm = _inputs(2, s, g, 0)
    y_ref, st_ref = j_ssd.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), CHUNK)
    y, st = t_ssd.ssd_scan(*(torch.as_tensor(v) for v in (x, dt, a, bm, cm)), CHUNK)
    assert y.shape == (2, s, H, P) and st.shape == (2, H, P, N)
    _close(y, y_ref)
    _close(st, st_ref)
    y_seq, st_seq = ssd_sequential_ref(torch.as_tensor(x * dt[..., None]),
                                       torch.as_tensor(dt * a), torch.as_tensor(bm),
                                       torch.as_tensor(cm))
    _close(y, y_seq)
    _close(st, st_seq)


@pytest.mark.parametrize("g", GROUPS)
def test_grouped_ssd_stages_are_the_groups_one_group_stages(g):
    """Each head's outputs equal those of the one-group stages run on its
    group's B and C alone: the scores are one set per group, and the
    chunk states and the output read the head's group."""
    x, dt, a, bm, cm = _inputs(1, 32, g, 1)
    xdt, dA = torch.as_tensor(x * dt[..., None]), torch.as_tensor(dt * a)
    bm, cm = torch.as_tensor(bm), torch.as_tensor(cm)
    cum = chunk_cumsum(dA, CHUNK)
    scores = chunk_scores(bm, cm, CHUNK)
    assert scores.shape == (1, 32 // CHUNK, g, CHUNK, CHUNK)
    states = chunk_states(xdt, bm, cum, CHUNK)
    entering, final = state_passing(states, cum)
    y = chunk_scan(xdt, cm, scores, cum, entering, CHUNK)
    hg = H // g
    for grp in range(g):
        heads = slice(grp * hg, (grp + 1) * hg)
        one = ssd_chunk_ref_saving(xdt[:, :, heads], dA[:, :, heads], bm[:, :, grp],
                                   cm[:, :, grp], CHUNK)
        torch.testing.assert_close(scores[:, :, grp:grp + 1],
                                   chunk_scores(bm[:, :, grp], cm[:, :, grp], CHUNK))
        torch.testing.assert_close(y[:, :, heads], one[0])
        torch.testing.assert_close(final[:, heads], one[1])
        torch.testing.assert_close(entering[:, :, heads], one[3])


@pytest.mark.parametrize("g", GROUPS)
def test_grouped_ssd_gradients_match_reference_grad(g):
    """``models.ssd.ssd_scan``'s autograd function (the plain chunk scan,
    then ``ssd_chunk_bwd_ref``: d(scores), dB and dC summed over each
    group's heads) against ``jax.grad`` through the reference's
    ``ssd_scan``: dx, ddt, dA, dB and dC, on a padded length."""
    x, dt, a, bm, cm = _inputs(2, SEQ, g, 2)
    dy = np.random.default_rng(g).normal(size=x.shape).astype(np.float32)
    args = (x, dt, a, bm, cm)

    def ref(*ins):
        y, _ = j_ssd.ssd_scan(*ins, CHUNK)
        return jnp.sum(y * dy)

    want = jax.jit(jax.grad(ref, argnums=tuple(range(5))))(*(jnp.asarray(t) for t in args))
    leaves = [torch.as_tensor(t).requires_grad_() for t in args]
    y, _ = t_ssd.ssd_scan(*leaves, CHUNK)
    (y * torch.as_tensor(dy)).sum().backward()
    for name, t, w in zip(("x", "dt", "a", "B", "C"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("g", GROUPS)
def test_grouped_chunk_bwd_ref_is_the_gradient_of_the_chunk_scan(g):
    """The plain backward against autograd through the plain forward, with
    the groups' B and C (B, S, G, N)."""
    x, dt, a, bm, cm = _inputs(2, 32, g, 3)
    xdt, dA, bm, cm = (torch.as_tensor(v) for v in (x * dt[..., None], dt * a, bm, cm))
    dy = torch.as_tensor(np.random.default_rng(3).normal(size=x.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (xdt, dA, bm, cm)]
    y, _ = ssd_ops.ssd_chunk_scan(*leaves, CHUNK)
    (y * dy).sum().backward()
    _, _, cum, entering = ssd_chunk_ref_saving(xdt, dA, bm, cm, CHUNK)
    got = ssd_chunk_bwd_ref(xdt, bm, cm, dy, cum, entering, CHUNK)
    for name, grad, t in zip(("dxdt", "ddA", "dbm", "dcm"), got, leaves):
        assert grad.shape == t.shape
        torch.testing.assert_close(grad, t.grad, atol=2e-4, rtol=1e-3, msg=name)


@pytest.fixture(scope="module", params=GROUPS)
def grouped_pair(request):
    """(JAX LM, JAX params, port cfg, port LM, port params): reduced
    mamba2-130m with ``ssd_ngroups`` groups on the reference's weights."""
    jcfg = dataclasses.replace(J_ARCHS["mamba2-130m"].reduced(), ssd_ngroups=request.param)
    jlm = JLM(jcfg)
    jparams = jlm.init(seed=3)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jlm, jparams, cfg, LM(cfg), params


def test_grouped_mamba2_prefill_and_decode_match_reference(grouped_pair):
    """Prefill logits and every layer's conv window and state, then three
    decode steps (each head's B and C its group's): logits and caches
    agree with the reference's LM."""
    jlm, jparams, cfg, lm, params = grouped_pair
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    max_len = SEQ + 4
    logits_ref, cache_ref = jlm.prefill(jparams, jnp.asarray(tokens), max_len=max_len)
    logits, cache = lm.prefill(params, torch.as_tensor(tokens), max_len=max_len)
    _close(logits, logits_ref)

    def check_caches():
        for name in ("conv", "state"):
            got = torch.stack([layer[name] for layer in cache["layers"]]).numpy()
            _close(got, cache_ref["blocks"][0][name])

    check_caches()
    steps = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    for t in range(3):
        tok = steps[:, t:t + 1]
        logits_ref, cache_ref = jlm.decode_step(jparams, cache_ref, jnp.asarray(tok))
        logits, cache = lm.decode_step(params, cache, torch.as_tensor(tok))
        _close(logits, logits_ref)
        check_caches()


def test_grouped_mamba2_forward_matches_reference(grouped_pair):
    jlm, jparams, cfg, lm, params = grouped_pair
    tokens = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    ref, _ = jlm.forward(jparams, jnp.asarray(tokens))
    _close(lm.forward(params, torch.as_tensor(tokens)), ref)


@pytest.mark.parametrize("g", [1] + GROUPS)
def test_grouped_fake_branch_counts_the_groups(g):
    """On fake tensors K5 and K5b allocate their scores (and K5b's summed
    d(scores)) per group, and count the scores' products once per group."""
    from repro_torch.launch import costmodel as cm_mod
    from repro_torch.launch.hlo_analysis import StepTrace

    b, s = 2, 32
    kernels.reset_launch_counts()
    with cm_mod.fake_mode() as mode:
        xdt = mode.from_tensor(torch.zeros((b, s, H, P)))
        dA = mode.from_tensor(torch.zeros((b, s, H)))
        bm = mode.from_tensor(torch.zeros((b, s, g, N)))
        with StepTrace([xdt, dA, bm, bm]) as t:
            y, final, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, dA, bm, bm, CHUNK)
            stages = ssd_ops.ssd_chunk_scan_stages(xdt, dA, bm, bm, CHUNK)
            grads = ssd_ops.ssd_chunk_bwd(xdt, bm, bm, y, cum, entering, CHUNK)
    assert stages.scores.shape == (b, s // CHUNK, g, CHUNK, CHUNK)
    assert [tuple(x.shape) for x in grads] == [(b, s, H, P), (b, s, H), (b, s, g, N),
                                               (b, s, g, N)]
    once = ssd_ops.ssd_flops(b, s, H, P, N, CHUNK, g)
    assert once - ssd_ops.ssd_flops(b, s, H, P, N, CHUNK) == 2 * b * (s // CHUNK) * (
        (g - 1) * CHUNK * CHUNK * N)
    assert t.flops == 2 * once + 2 * once
    assert kernels.fake_launch_counts()["ssd"] == 2
    assert kernels.fake_launch_counts()["ssd_bwd"] == 1


def test_grouped_ssd_refuses_groups_that_do_not_divide_the_heads():
    x, dt, a, bm, cm = _inputs(1, 16, 3, 4)  # 3 groups for 16 heads
    with pytest.raises(ValueError, match="groups must divide the heads"):
        ssd_ops.ssd(*(torch.as_tensor(v) for v in (x, dt, a, bm, cm)), chunk=CHUNK)
