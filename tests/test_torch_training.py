"""The port's training path (repro_torch.training, LM.loss, the backward
kernels' plain versions) against the JAX package's, on the CPU.

Both packages compute on identical state: weights, optimizer states and
checkpoints cross through numpy (``convert``) or the shared on-disk
format; inputs are made with numpy from a seed.  Float32 throughout
unless a test says otherwise.  The gradients of the two attention and
SSD backwards (K3b's and K5b's plain versions, reached through the
models' autograd functions) are held against ``jax.vjp``/``jax.grad`` of
the reference's ``flash_attention`` (its custom VJP ``_flash_core``) and
``ssd_scan``; then the optimizer, the compression round, the checkpoints
in both directions, the trainer's behaviours, and a 10-step run resumed
by both trainers from one reference checkpoint.  ``LM.loss``'s gradients
against ``jax.value_and_grad(model.loss)`` are in
tests/test_torch_training_grads.py.
"""
import dataclasses
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.data import LMDataConfig as JLMDataConfig
from repro.data import LMDataset as JLMDataset
from repro.models import LM as JLM
from repro.models import attention as j_attn
from repro.models import rglru as j_rglru
from repro.models import ssd as j_ssd
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import Trainer as JTrainer
from repro.training import TrainerConfig as JTrainerConfig
from repro.training import adamw_step as j_adamw_step
from repro.training import checkpoint as j_ckpt
from repro.training import compressed_psum_tree as j_compressed_psum_tree
from repro.training import init_error_feedback as j_init_error_feedback
from repro.training import init_opt_state as j_init_opt_state
from repro.training import quantize8 as j_quantize8
from repro.training.optimizer import learning_rate as j_learning_rate
from repro_torch import convert
from repro_torch.configs import ARCHS, ModelConfig
from repro_torch.data import LMDataConfig, LMDataset
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref, rglru_scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import LM
from repro_torch.models import rglru as t_rglru
from repro_torch.models.attention import flash_attention_autograd
from repro_torch.models.ssd import ssd_scan
from repro_torch.training import (
    OptimizerConfig,
    Trainer,
    TrainerConfig,
    adamw_step,
    checkpoint as ckpt,
    compressed_psum_tree,
    dequantize8,
    init_error_feedback,
    init_opt_state,
    quantize8,
)
from repro_torch.training.optimizer import learning_rate, tree_leaves


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread each, so that the
    suite's parallel workers do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _flat(tree, prefix=""):
    """{path: numpy array}, dict keys sorted, for leaf-by-leaf comparison."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float().numpy() if tree.is_floating_point() else tree.numpy()
    return {prefix: np.asarray(tree)}


def _assert_trees_close(got, want, atol, rtol=0.0):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(np.asarray(g[k], np.float64), np.asarray(w[k], np.float64),
                                   atol=atol, rtol=rtol, err_msg=k)


# ---------------------------------------------------------------- LM data


@pytest.mark.parametrize("kind", ["markov", "uniform"])
@pytest.mark.parametrize("hosts", [1, 2])
def test_lm_dataset_batches_equal_reference(kind, hosts):
    cfg = dict(vocab_size=97, seq_len=12, global_batch=4, kind=kind, branching=3, seed=5)
    ref, port = JLMDataset(JLMDataConfig(**cfg)), LMDataset(LMDataConfig(**cfg))
    for step in (0, 1, 17, 1000):
        for host in range(hosts):
            a = ref.batch_at(step, host, hosts)["tokens"]
            b = port.batch_at(step, host, hosts)["tokens"]
            assert b.dtype == a.dtype and np.array_equal(a, b)
    assert port.entropy_floor() == ref.entropy_floor()


# ---------------------------------------------------------------- optimizer


def test_learning_rate_matches_reference():
    for kw in ({}, {"warmup_steps": 10, "total_steps": 110, "min_lr_ratio": 0.1},
               {"warmup_steps": 0, "total_steps": 50, "learning_rate": 1.0}):
        jcfg, cfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
        got = np.array([float(learning_rate(cfg, s)) for s in range(201)])
        want = np.array([float(j_learning_rate(jcfg, s)) for s in range(201)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _opt_tree(rng, dtype):
    shapes = {"w": (6, 5), "blocks": [{"a": (3, 4, 7)}, {"b": (9,)}]}

    def draw(shape):
        return rng.normal(size=shape).astype(np.float32)

    return jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32-moments", "int8-moments"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_step_matches_reference(dtype, quantized):
    """Five steps on a tree of weights (with a master copy in bf16), with
    clipping, warmup and decay: weights, master, moments and metrics
    within 1e-6 of the reference."""
    rng = np.random.default_rng(11)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20, grad_clip=0.5,
              quantize_moments=quantized)
    jcfg, cfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    w = _opt_tree(rng, dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), w)
    params = jax.tree.map(lambda a: torch.as_tensor(a).to(tdt), w)
    jstate, state = j_init_opt_state(jparams, jcfg), init_opt_state(params, cfg)
    assert (state["master"] is None) == (jstate["master"] is None)
    for _ in range(5):
        g = _opt_tree(rng, dtype)
        jparams, jstate, jm = j_adamw_step(jax.tree.map(lambda a: jnp.asarray(a, jdt), g),
                                           jstate, jparams, jcfg)
        params, state, m = adamw_step(jax.tree.map(lambda a: torch.as_tensor(a).to(tdt), g),
                                      state, params, cfg)
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-9
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    _assert_trees_close(params, jax.tree.map(np.asarray, jparams), 1e-6)
    got = convert.opt_state_to_arrays(state)
    want = convert.opt_state_to_arrays(jax.tree.map(np.asarray, jstate))
    assert int(got["step"]) == int(want["step"]) == 5
    for key in ("master", "m", "v"):
        g, wnt = _flat(got[key]), _flat(want[key])
        assert sorted(g) == sorted(wnt)
        for k in wnt:
            if wnt[k].dtype == np.int8:
                np.testing.assert_array_equal(g[k], wnt[k], err_msg=f"{key}{k}")
            else:
                np.testing.assert_allclose(g[k], wnt[k], atol=1e-6, err_msg=f"{key}{k}")


def test_opt_state_crosses_packages():
    rng = np.random.default_rng(2)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _opt_tree(rng, "bf16"))
    jstate = j_init_opt_state(jparams, JOptimizerConfig(quantize_moments=True))
    state = convert.opt_state_from_arrays(jax.tree.map(np.asarray, jstate), device="cpu")
    assert state["step"].device.type == "cpu" and state["step"].dtype == torch.int32
    assert state["m"]["w"]["q"].dtype == torch.int8
    _assert_trees_close(convert.opt_state_to_arrays(state)["master"],
                        jax.tree.map(np.asarray, jstate["master"]), 0.0)


# ---------------------------------------------------------------- compression


def test_quantize8_matches_reference():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(8, 64)) * 3).astype(np.float32)
    x[3] = 0.0  # an all-zero row: the scale's floor
    jq, js = j_quantize8(jnp.asarray(x))
    q, s = quantize8(torch.as_tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("seed", range(8))
def test_quantize8_bounded_error(seed):
    """|dequant(q) - x| <= scale / 2 + 4 eps32 |x|.  The reference's test
    (tests/test_training.py:218) allows 1e-9 beyond the half step, which
    float32 cannot keep: x / scale and q * scale are each rounded to
    float32, which at |x| up to ~30 errs by up to a few 1e-8 (ROADMAP, C2).
    Seeds 0-1000 of its draw hold to this bound."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(8, 64)).astype(np.float32) * rng.uniform(0.1, 10))
    q, scale = quantize8(x)
    err = (dequantize8(q, scale) - x).abs()
    eps32 = float(np.finfo(np.float32).eps)
    assert bool((err <= scale / 2 + 4 * eps32 * x.abs()).all())


def test_error_feedback_preserves_signal():
    """As tests/test_training.py:226: the sum of compressed gradients plus
    the residual is the sum of the true ones, the residual bounded; and
    equal to the reference's round."""
    rng = np.random.default_rng(3)
    grads = [{"w": rng.normal(size=(16, 32)).astype(np.float32)} for _ in range(20)]
    ef = init_error_feedback({"w": torch.as_tensor(grads[0]["w"])})
    jef = j_init_error_feedback({"w": jnp.asarray(grads[0]["w"])})
    total_out = torch.zeros((16, 32))
    total_in = torch.zeros((16, 32))
    for g in grads:
        out, ef = compressed_psum_tree({"w": torch.as_tensor(g["w"])}, ef)
        jout, jef = j_compressed_psum_tree({"w": jnp.asarray(g["w"])}, jef)
        np.testing.assert_allclose(out["w"].numpy(), np.asarray(jout["w"]), atol=1e-6)
        total_out += out["w"]
        total_in += torch.as_tensor(g["w"])
    assert float((total_in - total_out - ef["w"]).abs().max()) < 1e-4
    one_step_scale = float(np.abs(grads[0]["w"]).max()) / 127
    assert float(ef["w"].abs().max()) < 20 * one_step_scale
    # a named axis needs a mesh: the all-reduce itself is held against the
    # reference's on gloo ranks in tests/test_torch_launch.py
    with pytest.raises(ValueError, match="mesh="):
        compressed_psum_tree({"w": torch.zeros(2, 2)}, ef, axis_name="pod")


# ---------------------------------------------------------------- checkpoints


def _tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones((4,), dtype=torch.bfloat16) * 1.5},
        "lst": [torch.zeros((2,)), torch.tensor(3, dtype=torch.int32)],
        "none": None,
    }


def test_checkpoint_roundtrip_tmp_retention_and_corruption():
    with tempfile.TemporaryDirectory() as d:
        state = _tree()
        ckpt.save(d, 7, state, metadata={"note": "x"})
        restored, meta = ckpt.restore(d, device="cpu")
        assert meta == {"note": "x"} and isinstance(restored["lst"], list)
        assert restored["none"] is None
        assert restored["nested"]["b"].dtype == torch.bfloat16
        for a, b in zip(tree_leaves(state), tree_leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        os.makedirs(os.path.join(d, "step_00000008.tmp"))  # a crashed partial write
        assert ckpt.latest_step(d) == 7
        for s in range(8, 14):
            ckpt.save(d, s, state, keep=2)
        assert ckpt.list_steps(d) == [12, 13]
        npz = os.path.join(d, "step_00000013", "arrays.npz")
        data = dict(np.load(npz))
        data["a"] = data["a"] + 1
        np.savez(npz, **data)
        with pytest.raises(IOError, match="checksum"):
            ckpt.restore(d, 13, device="cpu")
        # no sharding named: the leaves come back whole (restoring onto
        # shardings: tests/test_torch_launch.py)
        whole, _ = ckpt.restore(d, 12, shardings={"a": None}, device="cpu")
        assert torch.equal(whole["a"], state["a"])


def test_checkpoints_cross_between_packages():
    """The reference's checkpoint restores in the port and the port's in
    the reference, float32, bfloat16 and integer leaves bit for bit."""
    rng = np.random.default_rng(9)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    bf = rng.normal(size=(7,)).astype(np.float32)
    jstate = {"f": jnp.asarray(f32), "b": jnp.asarray(bf, jnp.bfloat16),
              "i": jnp.asarray(3, jnp.int32), "q": [jnp.asarray([1, -2], jnp.int8)]}
    with tempfile.TemporaryDirectory() as d:
        j_ckpt.save(d, 1, jstate)
        got, _ = ckpt.restore(d, device="cpu")
        assert got["b"].dtype == torch.bfloat16 and got["q"][0].dtype == torch.int8
        np.testing.assert_array_equal(got["f"].numpy(), f32)
        np.testing.assert_array_equal(got["b"].float().numpy(),
                                      np.asarray(jstate["b"], np.float32))
        assert int(got["i"]) == 3 and got["q"][0].tolist() == [1, -2]
        ckpt.save(d, 2, got)
        back, _ = j_ckpt.restore(d, 2)
        for k in ("f", "b", "i"):
            assert back[k].dtype == np.asarray(jstate[k]).dtype
            np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(jstate[k]))
        np.testing.assert_array_equal(back["q"][0], np.asarray(jstate["q"][0]))


# ---------------------------------------------------------------- backward kernels' plain versions


@pytest.mark.parametrize("b,s,hq,hkv,d,window", [
    (2, 128, 4, 4, 32, 0), (1, 256, 8, 2, 64, 0), (2, 96, 4, 1, 32, 0),
    (1, 256, 4, 2, 32, 64), (1, 130, 2, 2, 16, 32),  # tests/test_kernels.py:22
    (1, 100, 4, 2, 16, 7), (2, 70, 6, 3, 16, 48),  # more windows
    # head dim 256: causal (gemma-7b's MHA), windowed at 8 over 4 (gemma3-4b)
    # and 16 over 1 (recurrentgemma-9b's local layers)
    (1, 64, 4, 4, 256, 0), (1, 80, 8, 4, 256, 16), (1, 70, 16, 1, 256, 24),
])
def test_flash_attention_backward_matches_reference_vjp(b, s, hq, hkv, d, window):
    """The autograd function (K3 forward with its logsumexp, then
    ``flash_attention_bwd_ref``) against ``jax.vjp`` of the reference's
    ``flash_attention``, whose gradient is the custom VJP of
    ``_flash_core``; and the logsumexp against ``_flash_core_fwd``'s."""
    rng = np.random.default_rng([b, s, hq, d, window])
    q, do = (rng.normal(size=(b, s, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, hkv, d)).astype(np.float32) for _ in range(2))
    chunk = max(s // 4, 16)

    def ref(q, k, v):
        return j_attn.flash_attention(q, k, v, causal=True, window=window, q_chunk=chunk,
                                      kv_chunk=chunk)

    out_ref, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention_autograd(*leaves, window)
    out.backward(torch.as_tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=2e-5, rtol=2e-5)
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5,
                                   err_msg=name)
    if s % chunk == 0:  # the reference's logsumexp, unpadded
        qg = j_attn._split_gqa(jnp.asarray(q), hkv)
        statics = (True, window, chunk, chunk, d ** -0.5, 0, s // chunk)
        _, (_, _, _, _, ls) = j_attn._flash_core_fwd(statics, qg, jnp.asarray(k), jnp.asarray(v))
        _, lse = flash_ops.flash_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                           window=window, return_lse=True)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ls).reshape(b, hq, s), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 16), (1, 100, 2, 16, 8, 32), (2, 45, 3, 8, 32, 16),  # padded
])
def test_ssd_backward_matches_reference_grad(b, s, h, p, n, chunk):
    """``models.ssd.ssd_scan``'s autograd function (the plain chunk scan,
    then ``ssd_chunk_bwd_ref``) against ``jax.grad`` through the
    reference's ``ssd_scan`` (src/repro/models/ssd.py:83), with lengths
    padded by dt = 0 steps; every input's gradient."""
    rng = np.random.default_rng([b, s, h, p, n])
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) * 0.5 + 0.1).astype(np.float32)
    a = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, 1, n)).astype(np.float32) * 0.3 for _ in range(2))
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    args = (x, dt, a, bm, cm)

    def ref(*ins):
        y, _ = j_ssd.ssd_scan(*ins, chunk)
        return jnp.sum(y * dy)

    want = jax.jit(jax.grad(ref, argnums=tuple(range(5))))(*(jnp.asarray(t) for t in args))
    leaves = [torch.as_tensor(t).requires_grad_() for t in args]
    y, _ = ssd_scan(*leaves, chunk)
    (y * torch.as_tensor(dy)).sum().backward()
    for name, t, w in zip(("x", "dt", "a", "B", "C"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_ssd_chunk_bwd_ref_is_the_gradient_of_the_chunk_scan():
    """The plain backward against autograd through the plain forward."""
    rng = np.random.default_rng(6)
    b, s, h, p, n, chunk = 2, 48, 3, 5, 7, 16
    xdt, bm, cm, dy = (torch.as_tensor(rng.normal(size=shape).astype(np.float32))
                       for shape in ((b, s, h, p), (b, s, n), (b, s, n), (b, s, h, p)))
    dA = torch.as_tensor(-rng.uniform(0, 0.5, size=(b, s, h)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (xdt, dA, bm, cm)]
    y, _ = ssd_ops.ssd_chunk_scan(*leaves, chunk)
    (y * dy).sum().backward()
    _, _, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, dA, bm, cm, chunk)
    got = ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk)
    for name, g, t in zip(("dxdt", "ddA", "dbm", "dcm"), got, leaves):
        torch.testing.assert_close(g, t.grad, atol=2e-5, rtol=2e-5, msg=name)


@pytest.mark.parametrize("b,s,width,h0,dh_last", [
    (2, 150, 8, False, False), (2, 150, 8, True, True), (1, 64, 5, True, False),
    (3, 1, 4, False, True), (2, 200, 6, True, True),
])
def test_rglru_scan_bwd_ref_is_the_gradient_of_the_scan(b, s, width, h0, dh_last):
    """The plain backward (the explicit reverse loop) against autograd
    through the plain forward loop, every input's gradient, with and
    without h0 and the last state's gradient; and the autograd function
    on the CPU (the saving forward, then the plain backward) the same."""
    rng = np.random.default_rng([b, s, width])
    u, gp, dy = (torch.as_tensor(rng.normal(size=(b, s, width)).astype(np.float32))
                 for _ in range(3))
    vecs = [torch.as_tensor((rng.normal(size=width) * 0.5).astype(np.float32)) for _ in range(5)]
    hs = torch.as_tensor(rng.normal(size=(b, width)).astype(np.float32)) if h0 else None
    dh = torch.as_tensor(rng.normal(size=(b, width)).astype(np.float32)) if dh_last else None
    got = rglru_scan_bwd_ref(u, gp, *vecs, dy, h0=hs, dh_last=dh)
    for scan in (rglru_scan_ref, rglru_ops.rglru_scan_autograd):
        leaves = [t.clone().requires_grad_() for t in [u, gp, *vecs] + ([hs] if h0 else [])]
        y, h_last = scan(*leaves[:7], leaves[7] if h0 else None)
        loss = (y * dy).sum() + ((h_last * dh).sum() if dh_last else 0.0)
        want = torch.autograd.grad(loss, leaves)
        assert (got[7] is None) == (not h0)
        for name, g, w in zip(("du", "dgpre", "da_w", "da_b", "dx_w", "dx_b", "dlam", "dh0"),
                              got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("b,s,width,h0,dh_last", [
    (2, 150, 8, True, True),  # ragged: two chunks and a span of 22 steps
    (2, 40, 8, False, True),  # S below a chunk
    (1, 65, 6, True, False),  # one step past a chunk
    (3, 300, 5, True, True), (2, 16, 4, False, False), (1, 1, 4, True, True),
])
def test_rglru_scan_bwd_chunked_ref_matches_sequential_and_reference_vjp(b, s, width, h0,
                                                                          dh_last):
    """The backward kernel's order (16-step span summaries, the adjoint
    pushed through them from the right, each span walked back from its
    entering value, sums by span, chunk and batch row) against the
    sequential reverse loop and against ``jax.vjp`` of the reference's
    ``_gates`` and ``associative_scan`` (``rglru_forward``'s combine, h0
    folded into the first step; src/repro/models/rglru.py:77), every
    input's gradient in float32 within 1e-4 + 1e-3 |ref| (the kernel's
    tolerance, tests/test_torch_cuda.py's RGLRU_BWD_TOL)."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_chunked_ref

    rng = np.random.default_rng([b, s, width, int(h0), int(dh_last)])
    u, gp, dy = (rng.normal(size=(b, s, width)).astype(np.float32) for _ in range(3))
    vecs = [(rng.normal(size=width) * 0.5).astype(np.float32) for _ in range(5)]
    hs = rng.normal(size=(b, width)).astype(np.float32) if h0 else None
    dh = rng.normal(size=(b, width)).astype(np.float32) if dh_last else None
    t = [torch.as_tensor(x) for x in (u, gp, *vecs)]
    t_h0 = torch.as_tensor(hs) if h0 else None
    t_dh = torch.as_tensor(dh) if dh_last else None
    got = rglru_scan_bwd_chunked_ref(*t, torch.as_tensor(dy), h0=t_h0, dh_last=t_dh)
    seq = rglru_scan_bwd_ref(*t, torch.as_tensor(dy), h0=t_h0, dh_last=t_dh)
    tol = dict(atol=1e-4, rtol=1e-3)
    names = ("du", "dgpre", "da_w", "da_b", "dx_w", "dx_b", "dlam", "dh0")
    for name, g, w in zip(names, got, seq):
        assert (g is None) == (w is None), name
        if g is not None:
            torch.testing.assert_close(g, w, **tol, msg=name)

    keys = ("a_gate_w", "a_gate_b", "x_gate_w", "x_gate_b", "Lambda")

    def ref(u, gp, *rest):
        params = dict(zip(keys, rest[:5]))
        a, bx = j_rglru._gates(params, u)
        if h0:
            bx = bx.at[:, 0, :].add(a[:, 0, :] * rest[5])
        _, h = jax.lax.associative_scan(
            lambda left, right: (left[0] * right[0], right[0] * left[1] + right[1]), (a, bx),
            axis=1)
        return h * jax.nn.gelu(gp, approximate=True), h[:, -1]

    args = [jnp.asarray(x) for x in (u, gp, *vecs)] + ([jnp.asarray(hs)] if h0 else [])
    _, vjp = jax.vjp(ref, *args)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh if dh_last else np.zeros((b, width),
                                                                         np.float32))))
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol, err_msg=name)


def _rglru_block_params(cfg, rng):
    d, lru, w = cfg.d_model, cfg.lru_width, cfg.conv_width

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"w_rec": normal(d, lru, scale=d ** -0.5),
            "w_gate_branch": normal(d, lru, scale=d ** -0.5),
            "conv_w": normal(w, lru, scale=0.3), "conv_b": normal(lru, scale=0.1),
            "a_gate_w": normal(lru, scale=0.5), "a_gate_b": normal(lru, scale=0.5),
            "x_gate_w": normal(lru, scale=0.5), "x_gate_b": normal(lru, scale=0.5),
            "Lambda": normal(lru, scale=0.5) + 1.0, "w_out": normal(lru, d, scale=lru ** -0.5)}


@pytest.mark.parametrize("b,s,h0", [(2, 21, False), (2, 21, True), (1, 150, True),
                                    (2, 130, False)])
def test_rglru_backward_matches_reference_vjp(b, s, h0):
    """``models.rglru.rglru_forward`` (the projections, the conv, then the
    scan's autograd function: the saving forward and the plain backward)
    against ``jax.vjp`` of the reference's ``rglru_forward``
    (src/repro/models/rglru.py:77), whose gradient ``jax.grad`` takes
    through ``_gates`` and ``associative_scan``: the gradients of x, h0 and
    every weight, given cotangents of the output and of the last state; with
    and without h0, lengths off a multiple of the kernel's chunk (atol
    1e-5, rtol 1e-4)."""
    cfg = J_ARCHS["recurrentgemma-9b"].reduced()
    rng = np.random.default_rng([b, s, int(h0)])
    params = _rglru_block_params(cfg, rng)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    hs = rng.normal(size=(b, cfg.lru_width)).astype(np.float32) if h0 else None
    dy = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    dh = rng.normal(size=(b, cfg.lru_width)).astype(np.float32)

    def ref(p, x, *h):
        y, (_, h_last) = j_rglru.rglru_forward(p, x, cfg, None, h[0] if h else None)
        return y, h_last

    jargs = (jax.tree.map(jnp.asarray, params), jnp.asarray(x)) + ((jnp.asarray(hs),) if h0 else ())
    _, vjp = jax.vjp(ref, *jargs)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    leaves = {k: torch.as_tensor(v).requires_grad_() for k, v in params.items()}
    xs = torch.as_tensor(x).requires_grad_()
    h0s = torch.as_tensor(hs).requires_grad_() if h0 else None
    layer = type("Rec", (), leaves)
    y, (_, h_last) = t_rglru.rglru_forward(layer, xs, ModelConfig(**dataclasses.asdict(cfg)),
                                           None, h0s)
    ((y * torch.as_tensor(dy)).sum() + (h_last * torch.as_tensor(dh)).sum()).backward()
    tol = dict(atol=1e-5, rtol=1e-4)
    for k in params:
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(want[0][k]), **tol,
                                   err_msg=k)
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(want[1]), **tol, err_msg="x")
    if h0:
        np.testing.assert_allclose(h0s.grad.numpy(), np.asarray(want[2]), **tol, err_msg="h0")


def test_serving_with_frozen_weights_builds_no_graph():
    """Weights come frozen: forward, prefill and decode record nothing, and
    a training step's unfrozen weights leave the serving results as they
    were."""
    cfg = ARCHS["tinyllama-1.1b"].reduced()
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)))
    logits = lm.forward(params, tokens)
    last, cache = lm.prefill(params, tokens, max_len=12)
    step, _ = lm.decode_step(params, cache, tokens[:, -1:])
    for t in (logits, last, step, *tree_leaves(cache["layers"])):
        assert t.grad_fn is None and not t.requires_grad
    params.requires_grad_(True)
    params.requires_grad_(False)
    torch.testing.assert_close(lm.forward(params, tokens), logits, atol=0, rtol=0)


# ---------------------------------------------------------------- trainer


def _datasets(cfg):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, kind="markov")
    return JLMDataset(JLMDataConfig(**kw)), LMDataset(LMDataConfig(**kw))


def _mk_trainer(d, total=30, every=10, fault_hook=None, max_restarts=3):
    cfg = ARCHS["mamba2-130m"].reduced()
    return Trainer(
        LM(cfg), _datasets(cfg)[1],
        opt_cfg=OptimizerConfig(learning_rate=3e-3, warmup_steps=2, total_steps=1000),
        cfg=TrainerConfig(total_steps=total, checkpoint_every=every, checkpoint_dir=d,
                          log_every=5, max_restarts=max_restarts),
        fault_hook=fault_hook, device="cpu",
    )


def test_trainer_learns_and_recovers_from_injected_faults():
    faults = {7, 15}

    def hook(step):
        if step in faults:
            faults.remove(step)
            raise RuntimeError(f"injected node failure at step {step}")

    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        step, _, opt, summary = _mk_trainer(d1, total=30).train()
        assert step == 29 and summary["restarts"] == 0 and int(opt["step"]) == 30
        assert summary["losses"][-1] < summary["losses"][0]
        step, _, _, summary = _mk_trainer(d2, total=25, every=5, fault_hook=hook).train()
        assert step == 24 and summary["restarts"] == 2 and not faults


def test_trainer_resume_is_deterministic_and_restarts_run_out():
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        _, params_a, _, _ = _mk_trainer(d1, total=20, every=100).train()
        _mk_trainer(d2, total=10, every=100).train()  # saves its final state at step 9
        _, params_b, _, _ = _mk_trainer(d2, total=20, every=100).train(resume=True)
        _assert_trees_close(params_b.to_tree(), params_a.to_tree(), 1e-6)

    def always(step):
        raise RuntimeError("always failing")

    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="max_restarts"):
            _mk_trainer(d, total=10, max_restarts=2, fault_hook=always).train()
    # shardings name a mesh: the sharded trainer runs on gloo ranks in
    # tests/test_torch_launch.py
    with pytest.raises(ValueError, match="no mesh"):
        Trainer(LM(ARCHS["mamba2-130m"].reduced()), None, shardings=({}, {}), device="cpu")


def test_trainer_preemption_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        tr = _mk_trainer(d, total=50, every=1000)

        def hook(step):
            if step == 7:
                tr._preempted = True  # what the SIGTERM handler sets

        tr.fault_hook = hook
        step, _, _, summary = tr.train()
        assert summary["preempted"] and step < 49
        assert ckpt.latest_step(d) is not None
        step2, *_ = _mk_trainer(d, total=12, every=1000).train(resume=True)
        assert step2 == 11


def test_trainer_resumes_reference_checkpoint_and_tracks_reference():
    """Whole path: the reference's Trainer writes its step-0 checkpoint for
    reduced mamba2-130m; each package's Trainer resumes from a copy of it
    and trains 10 steps on the same batches.  Losses within 1e-5 at every
    step, final weights within 1e-4; the port's final checkpoint restores
    in the reference."""
    jcfg = J_ARCHS["mamba2-130m"].reduced()
    jds, ds = _datasets(jcfg)
    okw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=1000)
    tkw = dict(total_steps=11, checkpoint_every=1000, log_every=1)
    with tempfile.TemporaryDirectory() as root:
        jdir, tdir = os.path.join(root, "ref"), os.path.join(root, "port")
        jtr = JTrainer(JLM(jcfg), jds, opt_cfg=JOptimizerConfig(**okw),
                       cfg=JTrainerConfig(checkpoint_dir=jdir, **tkw))
        jtr._save(0, *jtr.init_state(0))
        shutil.copytree(jdir, tdir)
        _, jparams, _, jsum = jtr.train()
        tr = Trainer(LM(_port_cfg(jcfg)), ds, opt_cfg=OptimizerConfig(**okw),
                     cfg=TrainerConfig(checkpoint_dir=tdir, **tkw), device="cpu")
        step, params, _, summary = tr.train()
        assert step == 10 and len(summary["losses"]) == len(jsum["losses"]) == 10
        np.testing.assert_allclose(summary["losses"], jsum["losses"], atol=1e-5, rtol=0)
        _assert_trees_close(params.to_tree(), jax.tree.map(np.asarray, jparams), 1e-4)
        back, _ = j_ckpt.restore(tdir, 10)
        _assert_trees_close(back["params"], jax.tree.map(np.asarray, jparams), 1e-4)


def test_training_entry_points_need_cuda_unless_cpu_is_named():
    """No silent fallback: without ``device="cpu"`` the trainer and the
    checkpoint restore raise on a host without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = ARCHS["mamba2-130m"].reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(LM(cfg), _datasets(cfg)[1])
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 0, {"w": torch.zeros(2)})
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.restore(d)
