"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips on a host without CUDA (the
kernels have no CPU mode).  On the card, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.  The CPU tests hold the plain versions against the
JAX package's Pallas kernels (tests/test_torch_kernels.py).  The last
tests run the serving lanes on the card: two thread lanes capturing and
replaying decode graphs at once, a lane's clock beside another stream's
work, a process lane's launch counts, and the closed loop: the
overlapped server's speculative scheduling beside a lane's capture, an
injected crash on a supervised lane, and a lane deadline beside another
stream's long kernel.  The pipeline's selection scan and its chunked
(speculative) scan are held bit for bit against their plain versions on
the three programs' table shapes and both residency carries, the chunked
one also against the sequential kernel, and the pipeline on the card
against the fast path on the card; the sharded rounds' two entry points
(``shard_round``) bit for bit against their plain versions, and the
sharded pipeline on the card against the unsharded one; the RG-LRU scan against its plain
loop; the decode step of recurrentgemma-9b and llama4-scout (the S = 1
scan, the routed MoE at batch 2) graphed and under
``set_sync_debug_mode("error")``.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.selection_scan import ops as scan_ops
from repro_torch.kernels.shard_round import ops as shard_ops
from repro_torch.kernels.spec_scan import ops as spec_ops
from repro_torch.kernels.knn.ref import knn_topk_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import (
    chunk_cumsum,
    chunk_scores,
    chunk_states,
    ssd_chunk_ref,
    ssd_sequential_ref,
    state_passing,
)
from repro_torch.kernels.utility import ops as util_ops
from repro_torch.kernels.utility.ref import utility_scores_ref

pytestmark = pytest.mark.cuda

PENALTIES = ["step", "linear", "sigmoid", "none"]
# The kernels against their plain versions on the card, as
# tests/test_kernels.py holds the Pallas kernels against their oracles.
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_ATOL, SSD_RTOL = 2e-4, 1e-3  # tests/test_kernels.py:192


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _knn_case(q, n, d, k, nc, device, integer=False):
    rng = np.random.default_rng([q, n, d, k, nc])
    if integer:  # exact distances: ties are ties in every summation order
        queries = rng.integers(-3, 4, size=(q, d)).astype(np.float32)
        base = rng.integers(-3, 4, size=(n // 2, d)).astype(np.float32)
        x = np.concatenate([base, base])
    else:
        queries = rng.normal(size=(q, d)).astype(np.float32)
        x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, nc, len(x)).astype(np.int32)
    xt = torch.as_tensor(x, device=device)
    return (torch.as_tensor(queries, device=device), xt, (xt * xt).sum(dim=1),
            torch.as_tensor(y, device=device))


@pytest.mark.parametrize("q,n,d,k,nc", [
    (16, 256, 8, 5, 3), (37, 700, 16, 1, 4), (128, 512, 32, 8, 6), (5, 40, 4, 5, 2),
    (1365, 20000, 28, 5, 7), (300, 5000, 24, 16, 2), (3, 100003, 32, 7, 6),
    # Q off the query tile (64 or 128), N off the 64-row staged tile, D = 200
    # (the widest the shared memory takes), D not a multiple of 4.
    (200, 6401, 24, 5, 3), (65, 777, 3, 2, 3), (129, 6401, 200, 5, 4), (1, 333, 200, 16, 5),
])
def test_knn_kernel_matches_plain(cuda, q, n, d, k, nc):
    args = _knn_case(q, n, d, k, nc, cuda)
    dk, lk = knn_ops.knn_topk(*args, k)
    dr, lr = knn_topk_ref(*args, min(k + 1, n))
    torch.cuda.synchronize()
    assert float((dk - dr[:, :k]).abs().max()) <= 1e-3
    votes = knn_ops.votes_from_labels(lk, nc)
    ref = knn_ops.votes_from_labels(lr[:, :k], nc)
    clear = (dr[:, -1] - dr[:, k - 1]) > 1e-3 if k < n else torch.ones_like(dr[:, 0], dtype=bool)
    assert not bool(((votes != ref).any(dim=1) & clear).any())


@pytest.mark.parametrize("q,n,d,k", [(40, 300, 6, 1), (64, 6000, 6, 5), (9, 40000, 3, 16)])
def test_knn_kernel_tie_rule(cuda, q, n, d, k):
    """Exact twins across tiles and slices: labels equal the plain version's."""
    args = _knn_case(q, n, d, k, 4, cuda, integer=True)
    _, lk = knn_ops.knn_topk(*args, k)
    _, lr = knn_topk_ref(*args, k)
    assert torch.equal(lk, lr)


@pytest.mark.parametrize("q,n,d,k", [(1365, 80000, 32, 5), (300, 20003, 24, 5),
                                     (129, 9000, 200, 16), (70, 5000, 3, 1)])
def test_knn_kernel_ties_across_slices(cuda, q, n, d, k):
    """Twins on both sides of every slice boundary of the kernel's plan,
    queried exactly from the rows beside every query-tile boundary:
    integer data, so every distance and every tie is exact."""
    queries, x, _, y = _knn_case(q, n, d, k, 4, "cpu", integer=True)
    n = x.shape[0]
    plan = knn_ops.knn_plan(q, n, d, k, torch.cuda.get_device_properties(0).multi_processor_count)
    bounds = [lo for lo, _ in plan.slice_bounds(n)[1:]]
    assert bounds, plan
    for b in bounds:
        x[b - 1] = x[b]
        y[b - 1] = (y[b] + 1) % 4
    rows = [j * plan.query_tile + o for j in range(1, -(-q // plan.query_tile))
            for o in (-1, 0) if j * plan.query_tile + o < q] or [0]
    for i, row in enumerate(rows):
        queries[row] = x[bounds[i % len(bounds)]]
    args = [t.to(cuda) for t in (queries, x, (x * x).sum(dim=1), y)]
    dk, lk = knn_ops.knn_topk(*args, k)
    dr, lr = knn_topk_ref(*args, k)
    assert torch.equal(lk, lr) and torch.equal(dk, dr)


def test_knn_kernel_counts_launches(cuda):
    args = _knn_case(8, 500, 4, 3, 2, cuda)
    before = knn_ops.counter.count
    knn_ops.knn_topk(*args, 3)
    assert knn_ops.counter.count == before + 1


@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("r,m,shared", [
    (7, 3, False), (64, 5, False), (300, 8, False), (4096, 6, False), (9000, 7, True),
    (1365, 1, False), (1, 1, True),
    # Across the plan's cluster split for M = 6 (7 filling blocks of 42-row
    # passes) and the summing block's capacity in f64 (a ring of two slots
    # per filling block from 4761 rows); M = 256 (a ring of 8-row chunks);
    # M = 1 at 4096.
    (293, 6, False), (294, 6, False), (295, 6, True), (4760, 6, False), (4761, 6, True),
    (1250, 256, False), (4096, 1, False),
])
def test_utility_kernel_matches_plain(cuda, penalty, r, m, shared):
    """f64 bit-identical to the plain version (tile and ordered means);
    f32 within 1e-6."""
    rng = np.random.default_rng([r, m, len(penalty)])
    acc = rng.uniform(0, 1, (r, m))
    dl = rng.uniform(-0.05, 0.3, r)
    comp = rng.uniform(0.0, 0.6, (m,) if shared else (r, m))
    for dtype in (torch.float64, torch.float32):
        a, d, e = (torch.as_tensor(v, dtype=dtype, device=cuda) for v in (acc, dl, comp))
        uk, mk = util_ops.utility_scores(a, d, e, penalty)
        ur, mr = utility_scores_ref(a, d, e, penalty)
        if dtype == torch.float64:
            assert torch.equal(uk, ur) and torch.equal(mk, mr)
        else:
            assert float((uk - ur).abs().max()) <= 1e-6
            assert float((mk - mr).abs().max()) <= 1e-6
    u_only, none = util_ops.utility_scores(a, d, e, penalty, with_means=False)
    assert none is None and torch.equal(u_only, uk)


# ------------------------------------------------ prefill attention (K3)


def _flash_plain(q, k, v, window):
    """The plain version, model layout in and out."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qk = q.reshape(b, sq, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)
    out = flash_attention_ref(qk, k.transpose(1, 2), v.transpose(1, 2), window=window)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window", [
    (2, 128, 128, 4, 4, 32, 0), (1, 256, 256, 8, 2, 64, 0), (2, 96, 96, 4, 1, 32, 0),
    (1, 256, 256, 4, 2, 32, 64), (1, 130, 130, 2, 2, 16, 32),  # tests/test_kernels.py:22
    (2, 37, 300, 8, 2, 64, 0), (1, 200, 200, 4, 1, 128, 0), (1, 65, 65, 32, 4, 64, 100),
    (3, 1, 50, 8, 8, 16, 0),
    # Every head dim with G = 1, 4 and 8, windows 0, 32 and 64, offset
    # queries (Sq < Skv) and lengths that are no multiple of the 64-key tile.
    # With a window, the later rows of a query tile see nothing in its first
    # KV tiles: their running max stays _NEG there, as the reference's does.
    (2, 130, 130, 8, 8, 16, 0), (1, 300, 300, 32, 4, 16, 32), (2, 37, 300, 16, 4, 16, 64),
    (1, 300, 300, 8, 2, 32, 0), (2, 130, 130, 16, 2, 32, 64), (1, 64, 300, 4, 4, 32, 32),
    (1, 130, 300, 32, 4, 64, 0), (2, 300, 300, 4, 4, 64, 64), (1, 130, 130, 8, 2, 64, 32),
    (1, 300, 300, 8, 1, 128, 0), (2, 130, 130, 4, 4, 128, 32), (1, 37, 130, 16, 4, 128, 64),
    (2, 1024, 1024, 32, 4, 64, 0),  # tinyllama's prefill shape, two rows
    # Head dim 256 (gemma-7b, gemma3-4b): the configurations of
    # tests/test_kernels.py:22, offset queries, gemma-7b's prefill shape
    # (two rows) and gemma3-4b's windowed prefill, 512 keys past the window.
    (2, 128, 128, 4, 4, 256, 0), (1, 256, 256, 8, 2, 256, 0), (2, 96, 96, 4, 1, 256, 0),
    (1, 256, 256, 4, 2, 256, 64), (1, 130, 130, 2, 2, 256, 32), (2, 37, 300, 8, 4, 256, 0),
    (2, 1024, 1024, 16, 16, 256, 0), (1, 1536, 1536, 8, 4, 256, 1024),
    # recurrentgemma-9b's local layers (MQA, G = 16 at head dim 256, window
    # 2048, past it too) and llama4's attention (G = 5 at head dim 128), two
    # rows of the serving prefill and an offset query block.
    (2, 1024, 1024, 16, 1, 256, 2048), (1, 2200, 2200, 16, 1, 256, 2048),
    (2, 1024, 1024, 40, 8, 128, 0), (1, 130, 300, 40, 8, 128, 0),
])
def test_flash_attention_kernel_matches_plain(cuda, b, sq, skv, hq, hkv, d, window, dtype):
    """bf16 runs on the tensor cores, f32 on the CUDA cores; each against
    the plain version at 2e-2 (bf16) or 2e-5 (f32)."""
    gen = torch.Generator(device=cuda).manual_seed(sq * 1000 + skv)
    q = torch.randn((b, sq, hq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    before = flash_ops.counter.count
    out = flash_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_ops.counter.count == before + 1
    ref = _flash_plain(q, k, v, window)
    assert out.dtype == dtype and out.shape == q.shape
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_flash_attention_kernel_takes_unaligned_views(cuda):
    """A bf16 view that starts off a 16-byte boundary is still served by
    the kernel (copied to an aligned tensor first)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    flat = torch.randn(1 + 3 * 2 * 70 * 4 * 32, generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = flat[1:].view(3, 2, 70, 4, 32).unbind(0)
    assert q.data_ptr() % 16 and q.is_contiguous()
    before = flash_ops.counter.count
    out = flash_ops.flash_attention(q, k, v)
    assert flash_ops.counter.count == before + 1
    torch.testing.assert_close(out.float(), _flash_plain(q, k, v, 0).float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_attention_kernel_is_causal(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, 150, 2, 64), generator=gen, device=cuda) for _ in range(3))
    out1 = flash_ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 70:] = 999.0
    v2[:, 70:] = -999.0
    out2 = flash_ops.flash_attention(q, k2, v2)
    torch.testing.assert_close(out1[:, :70], out2[:, :70], atol=1e-6, rtol=0)


# ---------------------------------------------------------- flash decode (K4)


def _decode_plain(q, k, v, lengths, window):
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    out = decode_attention_ref(q.reshape(b, hkv, hq // hkv, d), k.transpose(1, 2),
                               v.transpose(1, 2), lengths, window=window)
    return out.reshape(b, 1, hq, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hkv,g,s,d,window", [
    (2, 2, 4, 256, 32, 0), (3, 1, 8, 300, 64, 0), (2, 4, 1, 128, 32, 0),
    (2, 2, 2, 256, 32, 64),  # tests/test_kernels.py:65
    (8, 4, 8, 1040, 64, 0), (1, 1, 16, 5000, 128, 0), (4, 2, 8, 70, 16, 20),
    # Head dim 256: the configurations of tests/test_kernels.py:65, gemma-7b's
    # decode shape (MHA) and gemma3-4b's ring of 1024 slots (G = 2).
    (2, 2, 4, 256, 256, 0), (3, 1, 8, 300, 256, 0), (2, 4, 1, 128, 256, 0),
    (2, 2, 2, 256, 256, 64), (8, 16, 1, 1040, 256, 0), (4, 4, 2, 1024, 256, 0),
    # recurrentgemma-9b's local decode (one KV head, G = 16 at head dim 256,
    # its ring read with no window of its own) and llama4's (G = 5 at 128).
    (8, 1, 16, 1040, 256, 0), (8, 8, 5, 1040, 128, 0),
])
def test_decode_attention_kernel_matches_plain(cuda, b, hkv, g, s, d, window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(b * 10000 + s)
    q = torch.randn((b, 1, hkv * g, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    lengths = torch.randint(max(window, 1), s + 1, (b,), generator=gen, device=cuda,
                            dtype=torch.int32)
    lengths[0] = s  # one full row
    before = decode_ops.counter.count
    out = decode_ops.decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert decode_ops.counter.count == before + 1
    ref = _decode_plain(q, k, v, lengths, window)
    assert out.dtype == dtype and out.shape == q.shape
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_decode_attention_kernel_respects_lengths(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 1, 8, 64), generator=gen, device=cuda)
    k, v = (torch.randn((2, 700, 2, 64), generator=gen, device=cuda) for _ in range(2))
    lengths = torch.tensor([333, 1], dtype=torch.int32, device=cuda)
    out1 = decode_ops.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[0, 333:] = 555.0
    v2[0, 333:] = -555.0
    k2[1, 1:] = 555.0
    v2[1, 1:] = -555.0
    out2 = decode_ops.decode_attention(q, k2, v2, lengths)
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=0)


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 4, 8, 32])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_decode_attention_kernel_head_dims_and_groups(cuda, d, g, dtype, window):
    """Every head dim the kernel takes, with 1 to 32 query heads per KV head
    (32 takes four passes of 8), with and without a window."""
    gen = torch.Generator(device=cuda).manual_seed(d * 100 + g)
    b, hkv, s = 3, 2, 300
    q = torch.randn((b, 1, hkv * g, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    lengths = torch.tensor([s, 177, 41], dtype=torch.int32, device=cuda)
    out = decode_ops.decode_attention(q, k, v, lengths, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), _decode_plain(q, k, v, lengths, window).float(),
                               atol=tol, rtol=tol)


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    """On the card a head dim outside HEAD_DIMS, G > 32 and causal=False
    raise; nothing falls back to the plain versions."""
    q = torch.zeros((1, 8, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="takes D in"):
        flash_ops.flash_attention(q, q, q)
    with pytest.raises(NotImplementedError):
        flash_ops.flash_attention(q, q, q, causal=False)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    cache = torch.zeros((1, 8, 1, 96), device=cuda)
    with pytest.raises(ValueError, match="takes D in"):
        decode_ops.decode_attention(torch.zeros((1, 1, 1, 96), device=cuda), cache, cache,
                                    lengths)
    cache = torch.zeros((1, 8, 1, 256), device=cuda)
    with pytest.raises(ValueError, match="G <= 32"):
        decode_ops.decode_attention(torch.zeros((1, 1, 33, 256), device=cuda), cache, cache,
                                    lengths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_attention_kernel_edge_lengths(cuda, dtype):
    """Lengths of 0 (the output is 0, as the plain version's), 1, one
    block's share (capacity / 8, and 32), and the full capacity."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    s = 1280
    lengths = torch.tensor([0, 1, 32, s // 8, s, 1039], dtype=torch.int32, device=cuda)
    b = lengths.numel()
    q = torch.randn((b, 1, 32, 64), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, 4, 64), generator=gen, device=cuda).to(dtype) for _ in range(2))
    for window in (0, 100):
        out = decode_ops.decode_attention(q, k, v, lengths, window=window)
        tol = ATTN_TOL[dtype]
        torch.testing.assert_close(out.float(),
                                   _decode_plain(q, k, v, lengths, window).float(),
                                   atol=tol, rtol=tol)
        assert not out[0].any()


def test_decode_attention_kernel_capacity_far_above_length(cuda):
    """A cache of 8192 positions of which at most 50 are valid gives what an
    exact cache gives."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    q = torch.randn((4, 1, 16, 64), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((4, 8192, 2, 64), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    lengths = torch.tensor([50, 3, 17, 49], dtype=torch.int32, device=cuda)
    out = decode_ops.decode_attention(q, k, v, lengths)
    exact = decode_ops.decode_attention(q, k[:, :50].contiguous(), v[:, :50].contiguous(),
                                        lengths)
    torch.testing.assert_close(out.float(), _decode_plain(q, k, v, lengths, 0).float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), exact.float(), atol=2e-2, rtol=2e-2)


def test_decode_attention_kernel_keeps_no_state_between_calls(cuda):
    """Two launches of one call give identical outputs, and so do three
    replays of a CUDA graph that captured it; the graph reads the lengths
    on the device, so a replay after they change follows them."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn((8, 1, 32, 64), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((8, 1280, 4, 64), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    lengths = torch.tensor([1040, 129, 700, 1024, 300, 1039, 512, 890], dtype=torch.int32,
                           device=cuda)
    first = decode_ops.decode_attention(q, k, v, lengths)
    second = decode_ops.decode_attention(q, k, v, lengths)
    assert torch.equal(first, second)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_ops.decode_attention(q, k, v, lengths)  # warm-up on the capture stream
        graph.capture_begin()
        out = decode_ops.decode_attention(q, k, v, lengths)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    lengths.sub_(7)
    graph.replay()
    assert torch.equal(out, decode_ops.decode_attention(q, k, v, lengths))


# ------------------------------------------------------------- the model


def test_lm_on_the_card_matches_the_host(cuda):
    """A 2-layer float32 model at tinyllama's widths: prefill and decode on
    the card (K3, K4) against the same weights on the host (plain
    versions).  Tolerance: float32 sums over d_model 2048 and d_ff 5632 in
    other orders, two layers deep."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import LM

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"], num_layers=2, dtype="float32")
        lm = LM(cfg)
        params = lm.init(seed=0, device=cuda)
        host = LM(cfg).init(seed=0, device=cuda).to("cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 45), generator=torch.Generator().manual_seed(0))
        lc, cc = lm.prefill(params, tokens.to(cuda), max_len=49)
        lh, ch = lm.prefill(host, tokens, max_len=49)
        torch.testing.assert_close(lc.cpu(), lh, atol=1e-3, rtol=1e-3)
        for t in range(4):
            tok = lh.argmax(dim=-1, keepdim=True)
            lc, cc = lm.decode_step(params, cc, tok.to(cuda))
            lh, ch = lm.decode_step(host, ch, tok)
            torch.testing.assert_close(lc.cpu(), lh, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(cc["layers"][1]["k"].cpu(), ch["layers"][1]["k"],
                                   atol=1e-3, rtol=1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ------------------------------------------------------ SSD chunk scan (K5)


def _ssd_case(b, s, h, p, n, device):
    """The model-facing inputs of tests/test_kernels.py:185."""
    rng = np.random.default_rng([b, s, h, p, n])
    x = rng.normal(size=(b, s, h, p))
    dt = np.abs(rng.normal(size=(b, s, h))) * 0.5 + 0.1
    a_log = rng.normal(size=(h,)) * 0.3
    bm, cm = (rng.normal(size=(b, s, n)) * 0.3 for _ in range(2))
    return [torch.as_tensor(v, dtype=torch.float32, device=device)
            for v in (x, dt, a_log, bm, cm)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32), (2, 48, 8, 8, 32, 16),
    (2, 256, 24, 64, 128, 128), (1, 96, 3, 64, 128, 32), (3, 40, 2, 5, 7, 8),
    # One chunk and sixteen, chunks of 16 to 128, P in {8, 64}, N in {8, 128}.
    (1, 128, 4, 64, 128, 128), (2, 2048, 4, 64, 128, 128), (2, 1024, 3, 8, 8, 64),
    (1, 64, 2, 64, 8, 64), (2, 512, 2, 8, 128, 32), (1, 16, 3, 8, 8, 16),
    (1, 256, 5, 64, 128, 16),
])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, chunk):
    """y and the final state against the chunked plain version on the
    card, and against the step-by-step recurrence."""
    x, dt, a_log, bm, cm = _ssd_case(b, s, h, p, n, cuda)
    y, state = ssd_ops.ssd(x, dt, a_log, bm, cm, chunk=chunk)
    dA = dt * -torch.exp(a_log)
    xdt = x * dt[..., None]
    y_ref, state_ref = ssd_chunk_ref(xdt, dA, bm, cm, chunk)
    torch.testing.assert_close(y, y_ref, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(state, state_ref, atol=SSD_ATOL, rtol=SSD_RTOL)
    if s <= 128:
        y_seq, state_seq = ssd_sequential_ref(xdt, dA, bm, cm)
        torch.testing.assert_close(y, y_seq, atol=SSD_ATOL, rtol=SSD_RTOL)
        torch.testing.assert_close(state, state_seq, atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 256, 24, 64, 128, 128), (1, 128, 4, 64, 128, 128), (2, 1024, 3, 8, 8, 64),
    (2, 512, 2, 8, 128, 32), (1, 256, 5, 64, 128, 16), (3, 40, 2, 5, 7, 8),
])
def test_ssd_kernel_stages_match_plain_stages(cuda, b, s, h, p, n, chunk):
    """Each of K5's kernels against its plain stage on the same inputs:
    cum, the scores on and below the diagonal, the state entering every
    chunk, the final state and y (atol 2e-4, rtol 1e-3)."""
    x, dt, a_log, bm, cm = _ssd_case(b, s, h, p, n, cuda)
    dA = (dt * -torch.exp(a_log)).contiguous()
    xdt = (x * dt[..., None]).contiguous()
    before = ssd_ops.counter.count
    out = ssd_ops.ssd_chunk_scan_stages(xdt, dA, bm, cm, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.counter.count == before + 1  # five kernels, one K5 launch
    cum = chunk_cumsum(dA, chunk)
    torch.testing.assert_close(out.cum, cum, atol=SSD_ATOL, rtol=SSD_RTOL)
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=cuda))
    scores = chunk_scores(bm, cm, chunk)
    torch.testing.assert_close(out.scores[..., lower], scores[..., lower], atol=SSD_ATOL,
                               rtol=SSD_RTOL)
    entering, final_state = state_passing(chunk_states(xdt, bm, cum, chunk), cum)
    torch.testing.assert_close(out.entering, entering, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(out.final_state, final_state, atol=SSD_ATOL, rtol=SSD_RTOL)
    y_ref, _ = ssd_chunk_ref(xdt, dA, bm, cm, chunk)
    torch.testing.assert_close(out.y, y_ref, atol=SSD_ATOL, rtol=SSD_RTOL)


def test_ssd_kernel_strong_decay(cuda):
    """Decays summing below -100 inside a chunk: L is formed from
    differences of the cumsum, so no NaN and no underflowed quotient."""
    x, dt, a_log, bm, cm = _ssd_case(1, 256, 4, 64, 128, cuda)
    dt = dt * 8.0  # cum reaches about -400 over a 128-step chunk
    y, state = ssd_ops.ssd(x, dt, a_log, bm, cm, chunk=128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    dA = dt * -torch.exp(a_log)
    y_ref, state_ref = ssd_chunk_ref(x * dt[..., None], dA, bm, cm, 128)
    torch.testing.assert_close(y, y_ref, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(state, state_ref, atol=SSD_ATOL, rtol=SSD_RTOL)


def test_ssd_scan_ragged_length_on_the_card(cuda):
    """A length that is no multiple of the chunk, through models.ssd's
    padding: the card against the host, the final state included."""
    from repro_torch.models.ssd import ssd_scan

    x, dt, a_log, bm, cm = _ssd_case(2, 300, 4, 64, 128, cuda)
    a = -torch.exp(a_log)
    args = (x, dt, a, bm[:, :, None], cm[:, :, None])
    y, state = ssd_scan(*args, 128)
    y_host, state_host = ssd_scan(*(t.cpu() for t in args), 128)
    torch.testing.assert_close(y.cpu(), y_host, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(state.cpu(), state_host, atol=SSD_ATOL, rtol=SSD_RTOL)


def test_ssd_kernel_counts_launches_and_rejects(cuda):
    x, dt, a_log, bm, cm = _ssd_case(1, 32, 2, 8, 16, cuda)
    before = ssd_ops.counter.count
    ssd_ops.ssd(x, dt, a_log, bm, cm, chunk=16)
    assert ssd_ops.counter.count == before + 1
    with pytest.raises(ValueError):
        ssd_ops.ssd(x, dt, a_log, bm, cm, chunk=256)  # above the kernel's chunk limit
    with pytest.raises(TypeError):
        ssd_ops.ssd_chunk_scan(x.double(), dt, bm, cm, 16)
    assert ssd_ops.counter.count == before + 1


def test_mamba2_on_the_card_matches_the_host(cuda):
    """A 2-layer float32 mamba2-130m at full width: prefill (K5) and decode
    on the card against the same weights on the host (plain versions),
    logits and both caches.  Tolerance: float32 sums over d_model 768,
    d_inner 1536 and the 128-wide state in other orders, two layers deep."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import LM

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(ARCHS["mamba2-130m"], num_layers=2, dtype="float32")
        lm = LM(cfg)
        params = lm.init(seed=0, device=cuda)
        host = LM(cfg).init(seed=0, device=cuda).to("cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 200),
                               generator=torch.Generator().manual_seed(0))
        lc, cc = lm.prefill(params, tokens.to(cuda), max_len=204)
        lh, ch = lm.prefill(host, tokens, max_len=204)
        torch.testing.assert_close(lc.cpu(), lh, atol=1e-3, rtol=1e-3)
        for t in range(4):
            tok = lh.argmax(dim=-1, keepdim=True)
            lc, cc = lm.decode_step(params, cc, tok.to(cuda))
            lh, ch = lm.decode_step(host, ch, tok)
            torch.testing.assert_close(lc.cpu(), lh, atol=1e-3, rtol=1e-3)
        for name in ("conv", "state"):
            torch.testing.assert_close(cc["layers"][1][name].cpu(), ch["layers"][1][name],
                                       atol=1e-3, rtol=1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ------------------------------------------------------- the graphed decode


def _two_layer_f32(arch, cuda, layers=2, kv_quant=False):
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import LM

    cfg = dataclasses.replace(ARCHS[arch], num_layers=layers, dtype="float32",
                              kv_quant=kv_quant)
    lm = LM(cfg)
    return cfg, lm, lm.init(seed=0, device=cuda)


@pytest.mark.parametrize("arch,seq,layers,kv_quant", [
    pytest.param("tinyllama-1.1b", 45, 2, False, id="tinyllama-1.1b-45-2"),
    pytest.param("mamba2-130m", 200, 2, False, id="mamba2-130m-200-2"),
    pytest.param("gemma-7b", 45, 2, False, id="gemma-7b-45-2"),
    # one period: 5 ring layers past their window, 1 global
    pytest.param("gemma3-4b", 1030, 6, False, id="gemma3-4b-1030-6"),
    pytest.param("tinyllama-1.1b", 45, 2, True, id="tinyllama-1.1b-45-2-kv_quant"),
    pytest.param("gemma3-4b", 1030, 6, True, id="gemma3-4b-1030-6-kv_quant"),
    # one period: two RG-LRU layers (rglru_scan at S = 1) and an MQA ring
    pytest.param("recurrentgemma-9b", 300, 3, False, id="recurrentgemma-9b-300-3"),
    # one routed MoE layer, 16 experts at batch 2 (one group of 2)
    pytest.param("llama4-scout-17b-16e", 45, 1, False, id="llama4-scout-17b-16e-45-1"),
])
def test_graphed_decode_matches_eager(cuda, arch, seq, layers, kv_quant):
    """A float32 model at full width: the decode step replayed from a CUDA
    graph against the eager step on the card, from the same prefill cache:
    identical tokens, logits within 1e-5 (gemma3-4b's ring slots and
    lengths are built on the device at every replay; with ``kv_quant``
    each step's quantise and whole-cache dequantise are replayed too)."""
    from repro_torch.serving.backends import DecodeGraph, bucket_capacity

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg, lm, params = _two_layer_f32(arch, cuda, layers, kv_quant)
        steps = 5
        tokens = torch.randint(0, cfg.vocab_size, (2, seq),
                               generator=torch.Generator().manual_seed(1)).to(cuda)
        capacity = bucket_capacity(seq + steps + 1)
        logits, cache = lm.prefill(params, tokens, max_len=capacity)
        tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
        dec = DecodeGraph(params, cfg, 2, capacity, cuda, torch.cuda.graph_pool_handle(),
                          torch.cuda.Stream())
        dec.load(cache, tok)
        for step in range(steps):
            dec.step()
            logits, cache = lm.decode_step(params, cache, tok)
            tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
            torch.testing.assert_close(dec.logits, logits, atol=1e-5, rtol=1e-5)
            assert torch.equal(dec.tok, tok), step
        assert dec.captures == 1 and dec.replays == steps - 1
        assert int(dec.cache["pos"]) == int(cache["pos"]) == seq + steps
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_backend_counts_the_launches_of_replays(cuda):
    """K4's count after a backend's graphed decode equals that of the same
    number of eager steps: one launch per attention layer per step, the
    capture counted as nothing and every replay as one step."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.serving.backends import ProfiledBackend

    cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"], num_layers=3)
    new_tokens = 6
    backend = ProfiledBackend({"t": (cfg, 0)}, new_tokens=new_tokens, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    kernels.reset_launch_counts()
    for _ in range(2):  # the first batch captures, the second only replays
        backend.run_batch("t", prompts, [0, 1])
    graphed = kernels.launch_counts()["decode_attention"]
    stats = backend.graph_stats()
    assert stats["captures"] == 1 and stats["replays"] == 2 * (new_tokens - 1) - 1
    lm = LM(cfg)
    params = backend._get("t")[1]
    kernels.reset_launch_counts()
    with torch.inference_mode():
        for _ in range(2):
            logits, cache = lm.prefill(params, torch.as_tensor(prompts, device=cuda),
                                       max_len=64)
            tok = logits.argmax(dim=-1, keepdim=True)
            for _ in range(new_tokens - 1):
                logits, cache = lm.decode_step(params, cache, tok)
                tok = logits.argmax(dim=-1, keepdim=True)
    eager = kernels.launch_counts()["decode_attention"]
    assert graphed == eager == 2 * (new_tokens - 1) * cfg.num_layers


def test_backend_grows_its_shared_cache_and_captures_again(cuda):
    """The decode graphs of one (variant, capacity) share one cache: a
    batch of 3 after one of 1 makes a 3-row cache with a new graph pool
    and retires the 1-row graph, whose key is captured again on the new
    cache.  A batch of 1 at a new capacity then makes a 3-row cache at
    once, so the batch of 3 that follows there retires nothing.  Every
    batch's tokens equal the eager decode's."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.serving.backends import ProfiledBackend

    cfg = dataclasses.replace(ARCHS["tinyllama-1.1b"], num_layers=2)
    new_tokens = 4
    backend = ProfiledBackend({"t": (cfg, 0)}, new_tokens=new_tokens, device=cuda)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 300)).astype(np.int32)
    lm, params = LM(cfg), backend._get("t")[1]
    for b, s, cap in ((1, 40, 256), (3, 40, 256), (1, 40, 256), (3, 40, 256),
                      (1, 300, 512), (3, 300, 512)):
        report = backend.run_batch("t", prompts[:b, :s], list(range(b)))
        with torch.inference_mode():
            logits, cache = lm.prefill(params, torch.as_tensor(prompts[:b, :s], device=cuda),
                                       max_len=cap)
            tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
            eager = [tok]
            for _ in range(new_tokens - 1):
                logits, cache = lm.decode_step(params, cache, tok)
                tok = logits.argmax(dim=-1, keepdim=True).to(torch.int32)
                eager.append(tok)
        np.testing.assert_array_equal(report.tokens, torch.cat(eager, dim=1).cpu().numpy())
    for cap in (256, 512):
        rows, layers, _ = backend._caches[("t", cap)]
        assert rows == 3 and layers[0]["k"].shape[0] == 3
    assert sorted(backend._decoders) == [("t", 1, 256), ("t", 1, 512), ("t", 3, 256),
                                         ("t", 3, 512)]
    stats = backend.graph_stats()
    assert stats["captures"] == 5 and stats["graphs"] == 4


@pytest.mark.parametrize("arch,layers,kv_quant", [
    pytest.param("tinyllama-1.1b", 2, False, id="tinyllama-1.1b-2"),
    pytest.param("mamba2-130m", 2, False, id="mamba2-130m-2"),
    pytest.param("gemma-7b", 2, False, id="gemma-7b-2"),
    pytest.param("gemma3-4b", 6, False, id="gemma3-4b-6"),
    pytest.param("tinyllama-1.1b", 2, True, id="tinyllama-1.1b-2-kv_quant"),
    pytest.param("gemma3-4b", 6, True, id="gemma3-4b-6-kv_quant"),
    pytest.param("recurrentgemma-9b", 3, False, id="recurrentgemma-9b-3"),
    pytest.param("llama4-scout-17b-16e", 1, False, id="llama4-scout-17b-16e-1"),
])
def test_decode_step_reads_nothing_on_the_host(cuda, arch, layers, kv_quant):
    """The eager decode step under ``set_sync_debug_mode("error")``: no
    operation of the step waits for the card (no ``item``, ``int`` or copy
    back), which is what lets it be captured; at head dim 256 too, with
    gemma3-4b's ring slots, and with the int8 KV cache."""
    cfg, lm, params = _two_layer_f32(arch, cuda, layers, kv_quant)
    tokens = torch.randint(0, cfg.vocab_size, (2, 30),
                           generator=torch.Generator().manual_seed(2)).to(cuda)
    _, cache = lm.prefill(params, tokens, max_len=64)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    logits = torch.empty((2, cfg.vocab_size), device=cuda)
    lm.decode_into(params, cache, tok, logits)  # first use: libraries load, kernels build
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            lm.decode_into(params, cache, tok, logits)
            lm.decode_step(params, cache, tok)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(cache["pos"]) == 30 + 5


# ------------------------------------------------------ lanes on one card


def _lane_variants():
    import dataclasses

    from repro_torch.configs import ARCHS

    return {"t": (dataclasses.replace(ARCHS["tinyllama-1.1b"], num_layers=2), 0),
            "m": (dataclasses.replace(ARCHS["mamba2-130m"], num_layers=2), 1)}


# (variant, batch, prompt length) of each lane's batches, in order: the
# first batch of each key captures its decode graph, the later ones replay.
LANE_BATCHES = {
    0: [("t", 2, 40), ("t", 2, 40), ("m", 2, 50), ("t", 2, 40)],
    1: [("t", 3, 300), ("m", 4, 64), ("t", 3, 300), ("t", 3, 300)],
}


def _run_lane(backend, batches, seed):
    rng = np.random.default_rng(seed)
    out = []
    for name, b, s in batches:
        prompts = rng.integers(0, 32000, (b, s)).astype(np.int32)
        out.append(backend.run_batch(name, prompts, list(range(b))).tokens)
    return out


def test_thread_lanes_capture_and_replay_concurrently(cuda):
    """Two lanes spawned from one backend capture and replay decode graphs
    at the same time from two threads (thread-local capture mode, a stream
    each): the launch counts are exactly what the batches need, and each
    lane's tokens equal its serial run's."""
    from repro_torch import kernels
    from repro_torch.serving.backends import ProfiledBackend

    new_tokens = 5
    parent = ProfiledBackend(_lane_variants(), new_tokens=new_tokens, device=cuda)
    serial = {lane: _run_lane(parent.spawn(), batches, lane)
              for lane, batches in LANE_BATCHES.items()}
    backends = {lane: parent.spawn() for lane in LANE_BATCHES}
    barrier = threading.Barrier(len(backends))
    got, errors = {}, []

    def lane_main(lane):
        try:
            barrier.wait()
            got[lane] = _run_lane(backends[lane], LANE_BATCHES[lane], lane)
        except BaseException as err:  # re-raised below
            errors.append(err)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    threads = [threading.Thread(target=lane_main, args=(lane,)) for lane in backends]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    counts = kernels.launch_counts()
    batches = [b for bs in LANE_BATCHES.values() for b in bs]
    n_t = sum(name == "t" for name, _, _ in batches)
    n_m = len(batches) - n_t
    assert counts.get("flash_attention", 0) == 2 * n_t
    assert counts.get("decode_attention", 0) == 2 * n_t * (new_tokens - 1)
    assert counts.get("ssd", 0) == 2 * n_m
    for lane, backend in backends.items():
        stats = backend.graph_stats()
        assert stats["captures"] == len(set(LANE_BATCHES[lane])) and stats["replays"] > 0
        for mine, theirs in zip(got[lane], serial[lane]):
            np.testing.assert_array_equal(mine, theirs)


def test_lane_clock_excludes_concurrent_queued_work(cuda):
    """A lane synchronises its own stream only: a batch timed while another
    stream holds a long kernel reports its own seconds, not the wait."""
    from repro_torch.serving.backends import ProfiledBackend

    backend = ProfiledBackend(_lane_variants(), new_tokens=3, device=cuda)
    prompts = np.random.default_rng(0).integers(0, 32000, (2, 40)).astype(np.int32)
    for _ in range(2):  # captures, then a replayed run
        quiet = backend.run_batch("t", prompts, [0, 1])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    other = torch.cuda.Stream(cuda)
    with torch.cuda.stream(other):
        start.record()
        torch.cuda._sleep(10**8)
        end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10**8 / start.elapsed_time(end)
    busy_ms = 2000.0
    with torch.cuda.stream(other):
        torch.cuda._sleep(int(busy_ms * cycles_per_ms))
        done = torch.cuda.Event()
        done.record()
    report = backend.run_batch("t", prompts, [0, 1])
    assert not done.query(), "the other stream's kernel ended before the batch did"
    assert report.prefill_s + report.decode_s < 0.25 * busy_ms / 1e3
    np.testing.assert_array_equal(report.tokens, quiet.tokens)
    torch.cuda.synchronize()


def test_process_lane_returns_its_launch_counts(cuda):
    """A process lane on the card: its child owns a CUDA context, and the
    kernel launches of its batches arrive in this process's counts,
    exactly; its tokens equal a thread lane's over the same seeds."""
    from repro_torch import kernels
    from repro_torch.kernels import nvcc
    from repro_torch.serving.backends import ProfiledBackend
    from repro_torch.serving.runtime import ProcessLaneBackend

    nvcc.build()  # the child builds nothing
    new_tokens = 4
    variants = _lane_variants()
    batches = [("t", 2, 40), ("m", 2, 50), ("t", 2, 40)]
    here = _run_lane(ProfiledBackend(variants, new_tokens=new_tokens, device=cuda), batches, 7)
    lane = ProcessLaneBackend(ProfiledBackend(variants, new_tokens=new_tokens, device=cuda))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        there = _run_lane(lane, batches, 7)
    finally:
        lane.close()
    counts = kernels.launch_counts()
    assert counts.get("flash_attention", 0) == 2 * 2
    assert counts.get("decode_attention", 0) == 2 * 2 * (new_tokens - 1)
    assert counts.get("ssd", 0) == 2
    for mine, theirs in zip(there, here):
        np.testing.assert_array_equal(mine, theirs)


# ------------------------------------------------------ the closed loop on the card


def _lane_app():
    from repro_torch.core.accuracy import ModelProfile
    from repro_torch.core.types import Application

    models = [ModelProfile("t", recalls=[0.78, 0.86], latency_s=0.03, load_latency_s=0.02),
              ModelProfile("m", recalls=[0.88, 0.70], latency_s=0.02, load_latency_s=0.01)]
    return {"assistant": Application(name="assistant", models=models, penalty="sigmoid")}


def _lane_trace(n=24, dim=8):
    from repro_torch.core.types import Request

    rng = np.random.default_rng(3)
    labels = rng.integers(0, 2, n)
    feats = (np.where(labels[:, None] == 1, 0.6, -0.6)
             + rng.normal(size=(n, dim))).astype(np.float32)
    return [Request(rid=i, app="assistant", arrival_s=0.01 * i, deadline_s=0.01 * i + 0.4,
                    features=feats[i], true_label=int(labels[i])) for i in range(n)]


def _lane_prompt(req):
    return np.random.default_rng(req.rid).integers(0, 32000, 24 + req.rid % 5).astype(np.int32)


def _lane_schedule(rows):
    """A placed schedule of (rid, model, worker, order, batch_id, start) rows."""
    from repro_torch.core.types import Request, Schedule, ScheduleEntry

    return Schedule(entries=[
        ScheduleEntry(request=Request(rid=rid, app="assistant", arrival_s=0.0, deadline_s=5.0),
                      model=model, order=order, worker=w, batch_id=b, est_start_s=start,
                      est_latency_s=0.05)
        for rid, model, w, order, b, start in rows])


def test_overlapped_server_schedules_while_a_lane_captures(cuda, monkeypatch):
    """The overlapped loop's speculative pass launches K2 and K1 from the
    scheduling thread while a lane thread is inside its first decode
    graph's capture (held there until the pass is done): the capture
    survives, and the decisions, records and tokens equal the synchronous
    loop's."""
    from repro_torch import kernels
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import make_policy
    from repro_torch.core.sneakpeek import KNNSneakPeek
    from repro_torch.serving import backends
    from repro_torch.serving.runtime import ExecutorPool, LMExecutor
    from repro_torch.serving.server import EdgeServer

    in_capture, speculated = threading.Event(), threading.Event()
    real_decode = backends.DecodeGraph._decode

    def decode(self):
        if torch.cuda.is_current_stream_capturing() and not speculated.is_set():
            in_capture.set()
            speculated.wait(timeout=120)
        real_decode(self)

    monkeypatch.setattr(backends.DecodeGraph, "_decode", decode)
    spec_launches = {}

    class Server(EdgeServer):
        def _speculate(self, now):
            if speculated.is_set():
                return super()._speculate(now)
            assert in_capture.wait(timeout=120), "no lane reached a capture"
            before = kernels.thread_launch_counts()
            out = super()._speculate(now)
            torch.cuda.current_stream().synchronize()
            for name, n in kernels.thread_launch_counts().items():
                spec_launches[name] = n - before.get(name, 0)
            speculated.set()
            return out

    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, 400).astype(np.int32)
    x = (np.where(y[:, None] == 1, 0.6, -0.6) + rng.normal(size=(400, 8))).astype(np.float32)
    runs = {}
    for overlap in (True, False):  # the held capture first: the synchronous run holds none
        backend = backends.ProfiledBackend(_lane_variants(), new_tokens=4, device=cuda)
        workers = [Worker(0), Worker(1, speed=2.0)]
        pool = ExecutorPool.from_executor(LMExecutor(backend=backend), workers)
        server = (Server if overlap else EdgeServer)(
            _lane_app(), make_policy("SneakPeek"), executor=pool, workers=workers,
            sneakpeeks={"assistant": KNNSneakPeek(x, y, 2, k=5, device=cuda)},
            prompt_fn=_lane_prompt, preempt=True, overlap=overlap, device=cuda)
        with server:
            outs, stats = server.run(_lane_trace())
        reports = [r for o in outs
                   for r in (o["pending"].result().reports if overlap else o["reports"])]
        runs[overlap] = (
            [(e.request.rid, e.model, e.worker, e.order, e.batch_id)
             for o in outs for e in o["schedule"].sorted_entries()],
            dict(server._records), [(r.worker, r.request_ids, r.model) for r in reports],
            [r.tokens for r in reports], stats)
        captures = sum(lane.executor.backend.graph_stats()["captures"]
                       for lane in pool.lanes.values())
        assert captures > 0
    assert speculated.is_set()
    assert spec_launches.get("knn_topk", 0) > 0 and spec_launches.get("utility_scores", 0) > 0
    assert runs[True][:3] == runs[False][:3]
    for a, b in zip(runs[True][3], runs[False][3]):
        np.testing.assert_array_equal(a, b)
    assert runs[True][4].overlap_saved_s > 0


def test_supervised_lane_crash_launches_nothing_after_it(cuda):
    """An injected crash at a lane's second batch: that batch and the
    later ones fail (cascaded) and launch no kernel; the first batch's
    launches are exactly one prefill and its decode steps."""
    from repro_torch import kernels
    from repro_torch.core.multiworker import Worker
    from repro_torch.serving.backends import ProfiledBackend
    from repro_torch.serving.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.serving.runtime import ExecutorPool

    new_tokens = 4
    backend = ProfiledBackend(_lane_variants(), new_tokens=new_tokens, device=cuda)
    pool = ExecutorPool([Worker(0), Worker(1)], backend_factory=backend.spawn)
    sched = _lane_schedule([(0, "t", 0, 1, 0, 0.0), (1, "t", 0, 2, 1, 0.1),
                            (2, "m", 0, 3, 2, 0.2), (3, "m", 1, 1, 3, 0.0)])
    injector = FaultInjector(FaultPlan(specs=(FaultSpec("crash", window=0, worker=0, batch=1),)))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with pool:
        out = pool.execute_supervised(sched, _lane_prompt, injector=injector)
        lanes = pool.launch_counts
    assert [(f.worker, f.request_ids, f.kind, f.cascaded) for f in out.failures] == [
        (0, [1], "crash", False), (0, [2], "crash", True)]
    assert sorted(r.request_ids[0] for r in out.reports) == [0, 3]
    assert {k: n for k, n in lanes[0].items() if n} == {
        "flash_attention": 2, "decode_attention": 2 * (new_tokens - 1)}
    assert {k: n for k, n in lanes[1].items() if n} == {"ssd": 2}
    counts = kernels.launch_counts()
    assert (counts["flash_attention"], counts["decode_attention"], counts["ssd"]) == (
        2, 2 * (new_tokens - 1), 2)


def test_lane_deadline_is_recorded_beside_a_long_kernel(cuda):
    """A lane overrunning the shared deadline is recorded in ``timed_out``
    and joined once its own batches are done — not once another stream's
    long kernel ends: the gather returns while that kernel still runs."""
    from repro_torch.core.multiworker import Worker
    from repro_torch.serving.backends import ProfiledBackend
    from repro_torch.serving.runtime import ExecutorPool

    backend = ProfiledBackend(_lane_variants(), new_tokens=3, device=cuda)
    pool = ExecutorPool([Worker(0), Worker(1)], backend_factory=backend.spawn)
    sched = _lane_schedule([(0, "t", 0, 1, 0, 0.0), (1, "t", 0, 2, 1, 0.1),
                            (2, "m", 1, 1, 2, 0.0)])
    with pool:
        pool.execute_supervised(sched, _lane_prompt)  # captures, then replays
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        other = torch.cuda.Stream(cuda)
        with torch.cuda.stream(other):
            start.record()
            torch.cuda._sleep(10**8)
            end.record()
        torch.cuda.synchronize()
        cycles_per_ms = 10**8 / start.elapsed_time(end)
        with torch.cuda.stream(other):
            torch.cuda._sleep(int(3000.0 * cycles_per_ms))
            done = torch.cuda.Event()
            done.record()
        out = pool.execute_supervised(sched, _lane_prompt, timeout_s=1e-4)
        assert not done.query(), "the other stream's kernel ended before the gather did"
    assert 0 in out.timed_out
    assert sorted(r.request_ids[0] for r in out.reports) == [0, 1, 2] and out.failures == []
    torch.cuda.synchronize()


# ------------------------------------------------ the pipeline's selection scan

# (steps, members, models, workers, applications) of each program's tables.
SCAN_SHAPES = {
    "per_request": (4096, 1, 6, 1, 3),
    "max_accuracy": (700, 1, 6, 1, 3),
    "grouped": (17, 1300, 6, 1, 17),
    "multiworker": (40, 300, 6, 4, 3),
    # 2,400 model ids on four workers: a carry past the default 48 KiB of
    # shared memory, which the launch opts in to.
    "many_ids": (64, 20, 6, 4, 400),
}


def _scan_inputs(program, res_mode, device, seed=0):
    """Random step and application tables of one scan, quantized so exact
    ties happen, with integer byte sizes and a capacity that evicts."""
    rng = np.random.default_rng([seed, len(program), len(res_mode)])
    s, b, m, w, a = SCAN_SHAPES[program]
    n_ids = a * m  # the window's model universe, as the pipeline numbers it
    gid = np.full((a, m), -2, dtype=np.int64)
    valid = np.zeros((a, m), dtype=bool)
    for i in range(a):
        mi = int(rng.integers(1, m + 1))
        gid[i, :mi] = rng.permutation(n_ids)[:mi]
        valid[i, :mi] = True
    counts = rng.integers(1, b + 1, s)
    mask = (np.arange(b)[None, :] < counts[:, None]).astype(np.float64)
    res0 = np.full((w, n_ids), -1, dtype=np.int64)
    for wi in range(w):
        held = rng.permutation(n_ids)[: (1 if res_mode == "slot1" else 4)]
        res0[wi, : len(held)] = held
    if res_mode == "slot1":
        res0 = res0[:, :1].copy()
    tabs = {
        "acc": np.round(rng.uniform(0.5, 1.0, (s, b, m)) * 16) / 16,
        "mask": mask,
        "deadlines": np.where(mask > 0, rng.uniform(0.05, 3.0, (s, b)), 1.0),
        "bsize": counts.astype(np.float64),
        "lat": np.round(rng.uniform(0.001, 0.01, (s, w, m)) * 1024) / 1024,
        "step_app": rng.integers(0, a, s),
        "swap": np.round(rng.uniform(0.0, 0.05, (a, w, m)) * 1024) / 1024,
        "gid": gid,
        "valid": valid,
        "pen": rng.integers(0, 4, a),
        "pref": np.stack([rng.permutation(w * m) for _ in range(a)]),
    }
    fixed = None
    if program == "max_accuracy":
        fixed = np.array([rng.integers(0, valid[i].sum()) for i in tabs["step_app"]])
    sizes = np.tile(rng.integers(1, 600, n_ids).astype(np.float64) * 2**20, (w, 1))
    seed_args = (np.round(rng.uniform(0.1, 0.3, w) * 1024) / 1024, res0, sizes, 900.0 * 2**20)
    as_t = {k: torch.as_tensor(v, device=device) for k, v in tabs.items()}
    fixed_t = None if fixed is None else torch.as_tensor(fixed, device=device)
    return seed_args, as_t, fixed_t


def _run_scan(seed_args, tabs, fixed, res_mode):
    t0, res0, sizes, cap = seed_args
    return scan_ops.selection_scan(
        t0, res0, sizes, cap, res_mode, tabs["acc"], tabs["mask"], tabs["deadlines"],
        tabs["bsize"], tabs["lat"], tabs["step_app"], tabs["swap"], tabs["gid"], tabs["valid"],
        tabs["pen"], tabs["pref"], fixed)


@pytest.mark.parametrize("res_mode", ["slot1", "lru"])
@pytest.mark.parametrize("program", sorted(SCAN_SHAPES))
def test_selection_scan_kernel_matches_plain(cuda, program, res_mode):
    """Workers, models, starts and latencies bit-identical to the plain
    version (float64, no FMA contraction, the same association)."""
    seed_args, tabs, fixed = _scan_inputs(program, res_mode, cuda)
    got = _run_scan(seed_args, tabs, fixed, res_mode)
    host = {k: v.cpu() for k, v in tabs.items()}
    want = _run_scan(seed_args, host, None if fixed is None else fixed.cpu(), res_mode)
    assert torch.equal(got.cpu(), want)


def test_selection_scan_counts_launches_and_refuses(cuda):
    seed_args, tabs, _ = _scan_inputs("grouped", "lru", cuda)
    before = scan_ops.counter.count
    _run_scan(seed_args, tabs, None, "lru")
    assert scan_ops.counter.count == before + 1
    bad = (seed_args[0], seed_args[1], seed_args[2] + 0.5, seed_args[3])
    with pytest.raises(ValueError, match="integer byte counts"):
        _run_scan(bad, tabs, None, "lru")
    with pytest.raises(ValueError, match="must be"):
        _run_scan(seed_args, dict(tabs, pen=tabs["pen"].float()), None, "lru")
    assert scan_ops.counter.count == before + 1


@pytest.mark.parametrize("pool", [None, [(0, 1.0, 1.0), (1, 2.0, 1.0), (2, 0.5, 2.0)]],
                         ids=["one-worker", "pool"])
@pytest.mark.parametrize("capacity", [None, 400 * 2**20], ids=["single-slot", "evicting"])
def test_pipeline_on_the_card_matches_the_fast_path(cuda, capacity, pool):
    """Five policies, a carried state: the pipeline's schedules on the card
    equal the fast path's on the card, times bit-equal, one scan launch
    per window that does not take the brute-force branch."""
    from repro_torch.core.evaluation import evaluate
    from repro_torch.core.grouping import group_by_app, split_groups_by_label
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import POLICY_NAMES, make_policy, schedule_window
    from repro_torch.core.sneakpeek import attach_sneakpeek
    from repro_torch.core.streaming import StreamingState
    from repro_torch.data import applications as apps_mod

    apps, sneaks = apps_mod.build_benchmark_suite(seed=0, device=cuda)
    workers = [Worker(w, speed=s, load_scale=ls) for w, s, ls in pool] if pool else None
    wids = [w.wid for w in workers] if workers else None

    def sig(sched):
        return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
                 e.est_latency_s) for e in sched.sorted_entries()]

    for policy in POLICY_NAMES:
        states = [StreamingState(worker_ids=wids, memory_capacity_bytes=capacity)
                  for _ in range(2)]
        for w in range(3):
            reqs = apps_mod.make_requests(list(apps_mod.APP_SPECS.values()), per_app=40,
                                          deadline_std_s=0.05, seed=w, start_rid=1000 * w)
            for r in reqs:
                r.arrival_s += 0.1 * w
                r.deadline_s += 0.1 * w
            attach_sneakpeek(reqs, apps, sneaks, device=cuda)
            sigs = []
            for state, pipeline in zip(states, (False, True)):
                before = scan_ops.counter.count
                sched, _ = schedule_window(make_policy(policy, pipeline=pipeline), reqs, apps,
                                           0.1 * (w + 1), workers=workers, state=state,
                                           device=cuda)
                evaluate(sched, apps, 0.1 * (w + 1), state=state, device=cuda)
                launched = scan_ops.counter.count - before
                groups = group_by_app(reqs)
                if policy == "SneakPeek":
                    groups = split_groups_by_label(groups, apps)
                brute = workers is None and policy in ("Grouped", "SneakPeek") and \
                    len(groups) <= 3
                assert launched == (1 if pipeline and not brute else 0)
                sigs.append(sig(sched))
            assert sigs[1] == sigs[0], (policy, w)


# ------------------------------------------- the chunked (speculative) scan


def _run_spec(seed_args, tabs, fixed, res_mode, chunk):
    t0, res0, sizes, cap = seed_args
    return spec_ops.spec_scan(
        t0, res0, sizes, cap, res_mode, tabs["acc"], tabs["mask"], tabs["deadlines"],
        tabs["bsize"], tabs["lat"], tabs["step_app"], tabs["swap"], tabs["gid"], tabs["valid"],
        tabs["pen"], tabs["pref"], fixed, chunk=chunk)


@pytest.mark.parametrize("chunk", [1, 4, 16, 64])
@pytest.mark.parametrize("res_mode", ["slot1", "lru"])
@pytest.mark.parametrize("program", sorted(SCAN_SHAPES))
def test_spec_scan_kernel_matches_plain_and_sequential(cuda, program, res_mode, chunk):
    """The chunked kernel's decisions, starts and latencies bit-identical to
    its plain version's and to the sequential kernel's; rounds and
    conflicts equal the plain version's.  The 2,400-id LRU carry runs at
    every chunk: only the boundary carry is in shared memory (P7)."""
    seed_args, tabs, fixed = _scan_inputs(program, res_mode, cuda)
    before = spec_ops.counter.count
    got = _run_spec(seed_args, tabs, fixed, res_mode, chunk)
    assert spec_ops.counter.count == before + 1
    host = {k: v.cpu() for k, v in tabs.items()}
    want = _run_spec(seed_args, host, None if fixed is None else fixed.cpu(), res_mode, chunk)
    assert torch.equal(got.cpu(), want)
    seq = _run_scan(seed_args, tabs, fixed, res_mode)
    assert torch.equal(got[:, :-1], seq)
    rounds, conflicts = got[0, -1].item(), got[1, -1].item()
    assert -(-tabs["acc"].shape[0] // chunk) <= rounds and conflicts <= rounds


@pytest.mark.parametrize("pool", [None, [(0, 1.0, 1.0), (1, 2.0, 1.0), (2, 0.5, 2.0)]],
                         ids=["one-worker", "pool"])
def test_chunked_pipeline_on_the_card_matches_the_host(cuda, pool):
    """``chunk=16`` on the card: the sequential pipeline's schedules on the
    card, the chunk stats of the host's chunked pipeline, one
    ``spec_scan`` launch per scanned window and no sequential scan."""
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import POLICY_NAMES, make_policy, schedule_window
    from repro_torch.core.sneakpeek import attach_sneakpeek
    from repro_torch.core.streaming import StreamingState
    from repro_torch.data import applications as apps_mod

    apps, sneaks = apps_mod.build_benchmark_suite(seed=0, device=cuda)
    workers = [Worker(w, speed=s, load_scale=ls) for w, s, ls in pool] if pool else None
    wids = [w.wid for w in workers] if workers else None

    def sig(sched):
        return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
                 e.est_latency_s) for e in sched.sorted_entries()]

    for policy in POLICY_NAMES:
        reqs = apps_mod.make_requests(list(apps_mod.APP_SPECS.values()), per_app=60,
                                      deadline_std_s=0.05, seed=3)
        attach_sneakpeek(reqs, apps, sneaks, device=cuda)
        state = StreamingState(worker_ids=wids, memory_capacity_bytes=400 * 2**20)
        want, _ = schedule_window(make_policy(policy, pipeline=True), reqs, apps, 0.1,
                                  workers=workers, state=state, device=cuda)
        host, _ = schedule_window(make_policy(policy, pipeline=True, chunk=16), reqs, apps,
                                  0.1, workers=workers, state=state, device="cpu")
        before = (spec_ops.counter.count, scan_ops.counter.count)
        got, _ = schedule_window(make_policy(policy, pipeline=True, chunk=16), reqs, apps, 0.1,
                                 workers=workers, state=state, device=cuda)
        assert sig(got) == sig(want) == sig(host), policy
        assert got.chunk_stats == host.chunk_stats
        scanned = got.chunk_stats is not None
        assert (spec_ops.counter.count - before[0], scan_ops.counter.count - before[1]) == \
            (int(scanned), 0)


# ------------------------------------------------------------ the RG-LRU scan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,width,h0", [
    (2, 37, 64, False), (3, 1, 256, True), (8, 1024, 4096, True), (8, 1, 4096, True),
    (1, 300, 200, True),  # a width no multiple of the block
])
def test_rglru_scan_kernel_matches_plain(cuda, b, s, width, h0, dtype):
    """y and the last state against the plain sequential loop on the card:
    float32 within 1e-4 (the same recurrence, transcendental functions of
    another library), bf16 y within 2e-2 of its own rounding."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    g = torch.Generator(device=cuda).manual_seed(b * s + width)
    u, gp = (torch.randn((b, s, width), generator=g, device=cuda).to(dtype) for _ in range(2))
    vecs = [(torch.randn(width, generator=g, device=cuda) * 0.5).to(dtype) for _ in range(5)]
    hs = torch.randn((b, width), generator=g, device=cuda) if h0 else None
    before = rglru_ops.counter.count
    y, h_last = rglru_ops.rglru_scan(u, gp, *vecs, hs)
    assert rglru_ops.counter.count == before + 1
    y_ref, h_ref = rglru_scan_ref(u, gp, *vecs, hs)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert y.dtype == dtype and h_last.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h_last, h_ref, atol=1e-4, rtol=1e-4)


# ------------------------------------------------ the sharded rounds


def _shard_block_inputs(program, res_mode, device, rows=256):
    """A shard's block of the scan tables of ``program`` (its first
    ``rows`` steps), a carry per row (tails and resident ids drawn at
    random), tie-break ranks that invert the preference permutation, and on
    more than one worker the last worker padded (``wvalid`` False)."""
    seed_args, tabs, fixed = _scan_inputs(program, res_mode, device)
    t0, res0, sizes, cap = seed_args
    rng = np.random.default_rng([len(program), len(res_mode), rows])
    r = min(rows, tabs["acc"].shape[0])
    w, k = res0.shape
    n_ids = sizes.shape[1]
    t = t0[None, :] + np.round(rng.uniform(0.0, 0.5, (r, w)) * 1024) / 1024
    res = np.full((r, w, k), -1, dtype=np.int64)
    for i in range(r):
        for wi in range(w):
            held = rng.permutation(n_ids)[: min(k, int(rng.integers(0, 5)))]
            res[i, wi, : len(held)] = held
    pref = tabs["pref"].cpu().numpy()
    rank = np.empty_like(pref)
    for a in range(len(pref)):
        rank[a, pref[a]] = np.arange(pref.shape[1])
    block = {name: tabs[name][:r] for name in ("acc", "mask", "deadlines", "bsize", "lat",
                                               "step_app")}
    block.update({name: tabs[name] for name in ("swap", "gid", "valid", "pen")})
    block["rank"] = torch.as_tensor(rank, device=device)
    block["wvalid"] = torch.arange(w, device=device) < max(1, w - 1) if w > 1 else None
    carry = (torch.as_tensor(t, device=device), torch.as_tensor(res, device=device))
    return carry, block, None if fixed is None else fixed[:r], seed_args


def _score(carry, block, fixed, res_mode):
    return shard_ops.score_block(
        *carry, res_mode == "slot1", block["acc"], block["mask"], block["deadlines"],
        block["bsize"], block["lat"], block["step_app"], block["swap"], block["gid"],
        block["valid"], block["pen"], block["rank"], block["wvalid"], fixed)


@pytest.mark.parametrize("res_mode", ["slot1", "lru"])
@pytest.mark.parametrize("program", sorted(SCAN_SHAPES))
def test_shard_round_kernels_match_plain(cuda, program, res_mode):
    """``score_block`` on a block of rows, each against its own carry and
    against one expanded carry, and ``chain`` over the block's picks:
    every output bit-identical to the plain versions on host copies, one
    launch each."""
    carry, block, fixed, (t0, res0, sizes, cap) = _shard_block_inputs(program, res_mode, cuda)
    host = {k: v.cpu() if v is not None else None for k, v in block.items()}
    host_fixed = None if fixed is None else fixed.cpu()
    r = carry[0].shape[0]
    frozen = (carry[0][:1].expand(r, -1), carry[1][:1].expand(r, -1, -1))
    for c in (carry, frozen):
        before = shard_ops.counter.count
        got = _score(c, block, fixed, res_mode)
        assert shard_ops.counter.count == before + 1
        want = _score(tuple(x.cpu() for x in c), host, host_fixed, res_mode)
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    m = block["acc"].shape[2]
    f, i = got
    args = (torch.as_tensor(t0, device=cuda), torch.as_tensor(res0, device=cuda),
            torch.as_tensor(sizes, device=cuda), cap, res_mode == "slot1", i[0] // m, i[2],
            f[1], f[3])
    before = shard_ops.counter.count
    t_st, r_st = shard_ops.chain(*args)
    assert shard_ops.counter.count == before + 1
    want_t, want_r = shard_ops.chain(*(x.cpu() if isinstance(x, torch.Tensor) else x
                                       for x in args))
    assert torch.equal(t_st.cpu(), want_t) and torch.equal(r_st.cpu(), want_r)


@pytest.mark.parametrize("pool", [None, [(0, 1.0, 1.0), (1, 2.0, 1.0), (2, 0.5, 2.0)]],
                         ids=["one-worker", "pool"])
def test_sharded_pipeline_on_the_card_matches_unsharded(cuda, pool):
    """2 and 4 shard blocks on the card (``force_shard_devices``), chunk 0
    and 16, an evicting capacity: the schedules of the unsharded pipeline
    on the card, the shard stats of the same pipeline on the host, and
    ``shard_round`` launches only when sharded (``shard=1`` launches what
    the unsharded pipeline does)."""
    from repro_torch.core import shard as tshard
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import POLICY_NAMES, make_policy
    from repro_torch.core.sneakpeek import attach_sneakpeek
    from repro_torch.core.streaming import StreamingState
    from repro_torch.data import applications as apps_mod
    from repro_torch.kernels import launch_counts

    apps, sneaks = apps_mod.build_benchmark_suite(seed=0, device=cuda)
    workers = [Worker(w, speed=s, load_scale=ls) for w, s, ls in pool] if pool else None
    wids = [w.wid for w in workers] if workers else None

    def sig(sched):
        return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
                 e.est_latency_s) for e in sched.sorted_entries()]

    prev = tshard.force_shard_devices(4)
    try:
        for policy in POLICY_NAMES:
            reqs = apps_mod.make_requests(list(apps_mod.APP_SPECS.values()), per_app=40,
                                          deadline_std_s=0.05, seed=5)
            attach_sneakpeek(reqs, apps, sneaks, device=cuda)
            state = StreamingState(worker_ids=wids, memory_capacity_bytes=400 * 2**20)
            for chunk in (0, 16):
                pol = make_policy(policy, pipeline=True, chunk=chunk)
                launched = []
                for pipe in (tshard.WindowPipeline(apps, policy=pol, workers=workers,
                                                   device=cuda),
                             tshard.ShardedWindowPipeline(apps, policy=pol, workers=workers,
                                                          shard=1, device=cuda)):
                    before = launch_counts()
                    sched = pipe.schedule(reqs, 0.1, state=state)
                    after = launch_counts()
                    launched.append({k: n - before.get(k, 0) for k, n in after.items()
                                     if n != before.get(k, 0)})
                    if len(launched) == 1:
                        want = sched
                assert sig(sched) == sig(want) and launched[1] == launched[0]
                assert "shard_round" not in launched[1]
                for shards in (2, 4):
                    host = tshard.ShardedWindowPipeline(apps, policy=pol, workers=workers,
                                                        shard=shards, device="cpu")
                    host.schedule(reqs, 0.1, state=state)
                    pipe = tshard.ShardedWindowPipeline(apps, policy=pol, workers=workers,
                                                        shard=shards, device=cuda)
                    before = shard_ops.counter.count
                    got = pipe.schedule(reqs, 0.1, state=state)
                    assert sig(got) == sig(want), (policy, chunk, shards)
                    assert got.chunk_stats == want.chunk_stats
                    assert pipe.last_shard_stats == host.last_shard_stats
                    assert (shard_ops.counter.count > before) == \
                        (pipe.last_shard_stats is not None)
    finally:
        tshard.force_shard_devices(prev)


@pytest.mark.parametrize("pool", [None, [(0, 1.0, 1.0), (1, 2.0, 1.0), (2, 0.5, 2.0)]],
                         ids=["one-worker", "pool"])
def test_sharded_pipeline_across_cards_matches_unsharded(cuda, pool):
    """One shard per card (no forced devices): 2 up to every card of the
    host, chunk 0 and 16, an evicting capacity, the blocks and carries
    copied between the cards.  The schedules and ``chunk_stats`` of the
    unsharded pipeline on the first card, the shard stats of the same
    count of blocks on the host, ``shard_round`` launched on every card;
    then ``Simulation(shard=True)`` over three windows equal to
    ``Simulation(pipeline=True)``."""
    from repro_torch.core import shard as tshard
    from repro_torch.core import simulator as tsim
    from repro_torch.core.multiworker import Worker
    from repro_torch.core.scheduler import POLICY_NAMES, make_policy
    from repro_torch.core.sneakpeek import attach_sneakpeek
    from repro_torch.core.streaming import StreamingState
    from repro_torch.data import applications as apps_mod

    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        pytest.skip("needs two CUDA cards or more: one shard per card")
    assert tshard.force_shard_devices(None) is None
    apps, sneaks = apps_mod.build_benchmark_suite(seed=0, device=cuda)
    workers = [Worker(w, speed=s, load_scale=ls) for w, s, ls in pool] if pool else None
    wids = [w.wid for w in workers] if workers else None

    def sig(sched):
        return [(e.request.rid, e.model, e.order, e.batch_id, e.worker, e.est_start_s,
                 e.est_latency_s) for e in sched.sorted_entries()]

    for policy in POLICY_NAMES:
        reqs = apps_mod.make_requests(list(apps_mod.APP_SPECS.values()), per_app=40,
                                      deadline_std_s=0.05, seed=5)
        attach_sneakpeek(reqs, apps, sneaks, device=cuda)
        state = StreamingState(worker_ids=wids, memory_capacity_bytes=400 * 2**20)
        for chunk in (0, 16):
            pol = make_policy(policy, pipeline=True, chunk=chunk)
            want = tshard.WindowPipeline(apps, policy=pol, workers=workers,
                                         device=cuda).schedule(reqs, 0.1, state=state)
            for shards in range(2, n_dev + 1):
                prev = tshard.force_shard_devices(shards)
                try:
                    host = tshard.ShardedWindowPipeline(apps, policy=pol, workers=workers,
                                                        shard=shards, device="cpu")
                    host.schedule(reqs, 0.1, state=state)
                finally:
                    tshard.force_shard_devices(prev)
                pipe = tshard.ShardedWindowPipeline(apps, policy=pol, workers=workers,
                                                    shard=shards, device=cuda)
                assert pipe._mesh() == [torch.device("cuda", i) for i in range(shards)]
                before = shard_ops.counter.count
                got = pipe.schedule(reqs, 0.1, state=state)
                assert sig(got) == sig(want), (policy, chunk, shards)
                assert got.chunk_stats == want.chunk_stats
                assert pipe.last_shard_stats == host.last_shard_stats
                assert (shard_ops.counter.count > before) == \
                    (pipe.last_shard_stats is not None)

    trace = []
    for w in range(3):
        window = apps_mod.make_requests(list(apps_mod.APP_SPECS.values()), per_app=30,
                                        deadline_std_s=0.05, seed=6 + w, start_rid=100 * w)
        for r in window:
            r.arrival_s += 0.1 * w
            r.deadline_s += 0.1 * w
        trace += window
    runs = []
    for kwargs in ({"pipeline": True}, {"shard": True}):
        sim = tsim.Simulation(make_policy("SneakPeek"), apps, sneakpeeks=sneaks,
                              workers=workers, short_circuit=True, seed=0, chunk=16,
                              device=cuda, **kwargs)
        seen, real_eval = [], tsim.evaluate

        def spy(sched, *a, **kw):
            seen.append(sig(sched))
            return real_eval(sched, *a, **kw)

        tsim.evaluate = spy
        try:
            sim.run(trace)
        finally:
            tsim.evaluate = real_eval
        runs.append((sim, seen))
    assert runs[1][0]._pipeline.num_shards() == n_dev
    assert len(runs[0][1]) > 1 and runs[1][1] == runs[0][1]


# ---------------------------------------------------------------- backward kernels (K3b, K5b)

def _gqa_ref(t, hkv):
    b, s, hq, d = t.shape
    return t.reshape(b, s, hkv, hq // hkv, d).permute(0, 2, 3, 1, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window", [
    (2, 128, 128, 4, 4, 32, 0), (1, 256, 256, 8, 2, 64, 0), (2, 96, 96, 4, 1, 32, 0),
    (1, 256, 256, 4, 2, 32, 64), (1, 130, 130, 2, 2, 16, 32),  # tests/test_kernels.py:22
    (2, 37, 300, 8, 2, 64, 0), (1, 300, 300, 8, 1, 128, 0), (2, 130, 130, 4, 4, 128, 32),
    (2, 1024, 1024, 32, 4, 64, 0),  # tinyllama's training shape, two rows
    (1, 1024, 1024, 40, 8, 128, 0), (1, 1536, 1536, 8, 4, 128, 1024),  # llama4, a window
    # The tensor-core design's edges: Sq off a multiple of 64 and of 32,
    (1, 100, 100, 4, 2, 64, 0), (2, 77, 77, 8, 4, 128, 0),
    # Sq < Skv (queries at the last Sq positions),
    (1, 70, 200, 4, 2, 64, 0), (1, 45, 301, 8, 1, 128, 16),
    # a window smaller than a warp's 16 rows, windows off a multiple of a tile,
    (1, 200, 200, 4, 2, 64, 7), (2, 160, 160, 4, 2, 64, 100), (1, 300, 300, 4, 4, 128, 50),
    # G = 1 and G = 16 at D = 128.
    (1, 256, 256, 4, 4, 128, 0), (1, 256, 256, 16, 1, 128, 0),
])
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, sq, skv, hq, hkv, d, window, dtype):
    """K3's logsumexp and K3b's dq, dk and dv against the plain versions on
    the same inputs, forward output and logsumexp (2e-2 bf16, 2e-5 f32)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + skv)
    q = torch.randn((b, sq, hq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, skv, hkv, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((b, sq, hq, d), generator=gen, device=cuda).to(dtype)
    out, lse = flash_ops.flash_attention(q, k, v, window=window, return_lse=True)
    _, lse_ref = flash_attention_ref(_gqa_ref(q, hkv), k.transpose(1, 2), v.transpose(1, 2),
                                     window=window, return_lse=True)
    torch.testing.assert_close(lse, lse_ref.reshape(b, hq, sq), atol=2e-5, rtol=2e-5)
    before = flash_ops.bwd_counter.count
    dq, dk, dv = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    torch.cuda.synchronize()
    assert flash_ops.bwd_counter.count == before + 1
    refs = flash_attention_bwd_ref(_gqa_ref(q, hkv), k.transpose(1, 2), v.transpose(1, 2),
                                   _gqa_ref(out, hkv), _gqa_ref(do, hkv),
                                   lse.reshape(b, hkv, hq // hkv, sq), window=window)
    refs = (refs[0].permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d), refs[1].transpose(1, 2),
            refs[2].transpose(1, 2))
    tol = ATTN_TOL[dtype]
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape, name
        torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d,window", [(64, 0), (128, 100)])
def test_flash_attention_bwd_is_bit_identical_from_call_to_call(cuda, d, window, dtype):
    """K3b takes no atomics: two calls on the same inputs give the same
    gradients, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(d + window)
    b, s, hq, hkv = 2, 300, 8, 2
    q, do = (torch.randn((b, s, hq, d), generator=gen, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=cuda).to(dtype) for _ in range(2))
    out, lse = flash_ops.flash_attention(q, k, v, window=window, return_lse=True)
    first = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    second = flash_ops.flash_attention_bwd(q, k, v, out, do, lse, window=window)
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


def test_flash_attention_bwd_takes_inputs_off_a_16_byte_boundary(cuda):
    """The bf16 instance copies rows in 16-byte pieces; the wrapper copies an
    input that starts off a 16-byte boundary, and the gradients are those of
    the aligned inputs."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, s, hq, hkv, d = 1, 130, 4, 2, 64
    shapes = ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))
    aligned = [torch.randn(sh, generator=gen, device=cuda).to(torch.bfloat16) for sh in shapes]
    shifted = []
    for t in aligned:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)  # 2 bytes past an aligned base
        view.copy_(t)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        shifted.append(view)
    q, k, v, do = aligned
    out, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    want = flash_ops.flash_attention_bwd(q, k, v, out, do, lse)
    qs, ks, vs, dos = shifted
    got = flash_ops.flash_attention_bwd(qs, ks, vs, out, dos, lse)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(x, y), name


def test_flash_attention_bwd_refuses_head_dim_256(cuda):
    q = torch.zeros((1, 64, 2, 256), device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(NotImplementedError, match="queue 2, entry 7"):
        flash_ops.flash_attention_bwd(q, q, q, q, q, lse)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 4, 8, 16, 16), (1, 128, 2, 16, 8, 32), (2, 48, 8, 8, 32, 16),
    (3, 40, 2, 5, 7, 8), (2, 512, 2, 8, 128, 32), (1, 256, 5, 64, 128, 16),
    (2, 1024, 24, 64, 128, 128),  # mamba2-130m's training shape, two rows
    (2, 128, 3, 16, 32, 128), (1, 64, 2, 64, 128, 64),  # one chunk (nc = 1)
    (2, 256, 3, 12, 64, 64), (1, 128, 2, 37, 128, 32),  # P off a multiple of the pass's 8 rows
    (2, 256, 4, 64, 16, 128), (1, 192, 3, 24, 48, 64),  # N < 64
])
def test_ssd_bwd_kernel_matches_plain(cuda, b, s, h, p, n, chunk):
    """K5b's four gradients against ``ssd_chunk_bwd_ref`` on the same
    inputs and saved forward (atol 2e-4, rtol 1e-3)."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref

    x, dt, a_log, bm, cm = _ssd_case(b, s, h, p, n, cuda)
    dA = (dt * -torch.exp(a_log)).contiguous()
    xdt = (x * dt[..., None]).contiguous()
    dy = torch.randn((b, s, h, p), generator=torch.Generator(device=cuda).manual_seed(s),
                     device=cuda)
    y, _, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, dA, bm, cm, chunk)
    before = ssd_ops.bwd_counter.count
    grads = ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.bwd_counter.count == before + 1  # nine kernels, one K5b launch
    refs = ssd_chunk_bwd_ref(xdt, bm, cm, dy, cum, entering, chunk)
    for name, got, ref in zip(("dxdt", "ddA", "dbm", "dcm"), grads, refs):
        torch.testing.assert_close(got, ref, atol=SSD_ATOL, rtol=SSD_RTOL, msg=name)


def test_ssd_bwd_is_bit_identical_from_call_to_call(cuda):
    """K5b takes no atomics (the pass's per-block partials are summed in a
    fixed order): two calls on the same inputs give the same gradients,
    bit for bit."""
    b, s, h, p, n, chunk = 2, 512, 6, 60, 128, 128
    x, dt, a_log, bm, cm = _ssd_case(b, s, h, p, n, cuda)
    dA = (dt * -torch.exp(a_log)).contiguous()
    xdt = (x * dt[..., None]).contiguous()
    dy = torch.randn((b, s, h, p), generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda)
    _, _, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, dA, bm, cm, chunk)
    first = ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk)
    second = ssd_ops.ssd_chunk_bwd(xdt, bm, cm, dy, cum, entering, chunk)
    for name, g1, g2 in zip(("dxdt", "ddA", "dbm", "dcm"), first, second):
        assert torch.equal(g1, g2), name


def test_ssd_scan_gradient_on_the_card_matches_the_host(cuda):
    """models.ssd.ssd_scan's autograd function (K5 then K5b) on a ragged
    length, card against host, every input's gradient."""
    from repro_torch.models.ssd import ssd_scan

    x, dt, a_log, bm, cm = _ssd_case(2, 300, 4, 64, 128, cuda)
    dy = torch.randn((2, 300, 4, 64), generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, dt, a_log, bm, cm)]
        xx, dd, al, bb, cc = leaves
        y, _ = ssd_scan(xx, dd, -torch.exp(al), bb[:, :, None], cc[:, :, None], 128)
        (y * dy.to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for name, got, ref in zip(("x", "dt", "a_log", "bm", "cm"), grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, ref, atol=SSD_ATOL, rtol=SSD_RTOL, msg=name)


def test_kernels_without_a_backward_refuse_gradients(cuda):
    """A CUDA call whose input requires a gradient raises, naming what to
    call or the ROADMAP label, rather than return an output that carries
    no gradient path."""
    q = torch.randn((2, 1, 4, 32), device=cuda, requires_grad=True)
    cache = torch.randn((2, 64, 2, 32), device=cuda)
    lengths = torch.full((2,), 10, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="Port rules', Gradients"):
        decode_ops.decode_attention(q, cache, cache, lengths)
    with torch.no_grad():
        decode_ops.decode_attention(q, cache, cache, lengths)  # nothing records: it runs
    qf = torch.randn((2, 64, 4, 32), device=cuda, requires_grad=True)
    kf = torch.randn((2, 64, 2, 32), device=cuda)
    with pytest.raises(RuntimeError, match="flash_attention_autograd"):
        flash_ops.flash_attention(qf, kf, kf)
    x = torch.randn((1, 32, 2, 8), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan"):
        ssd_ops.ssd_chunk_scan(x, torch.zeros((1, 32, 2), device=cuda),
                               torch.zeros((1, 32, 4), device=cuda),
                               torch.zeros((1, 32, 4), device=cuda), 16)
    u = torch.randn((1, 8, 16), device=cuda, requires_grad=True)
    vec = torch.zeros(16, device=cuda)
    with pytest.raises(RuntimeError, match="queue 2, entry 8"):
        rglru_ops.rglru_scan(u, u.detach(), vec, vec, vec, vec, vec)
    acc = torch.rand((8, 3), device=cuda, dtype=torch.float32, requires_grad=True)
    with pytest.raises(RuntimeError, match="Port rules', Gradients"):
        util_ops.utility_scores(acc, torch.ones(8, device=cuda), torch.ones(3, device=cuda))
