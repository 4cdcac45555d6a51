"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips on a host without CUDA (the
kernels have no CPU mode).  On the card, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.  The CPU tests hold the plain versions against the
JAX package's Pallas kernels (tests/test_torch_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.knn.ref import knn_topk_ref
from repro_torch.kernels.utility import ops as util_ops
from repro_torch.kernels.utility.ref import utility_scores_ref

pytestmark = pytest.mark.cuda

PENALTIES = ["step", "linear", "sigmoid", "none"]


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


def test_knn_kernel_counts_launches(cuda):
    args = _knn_case(8, 500, 4, 3, 2, cuda)
    before = knn_ops.counter.count
    knn_ops.knn_topk(*args, 3)
    assert knn_ops.counter.count == before + 1


@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("r,m,shared", [
    (7, 3, False), (64, 5, False), (300, 8, False), (4096, 6, False), (9000, 7, True),
    (1365, 1, False), (1, 1, True),
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
