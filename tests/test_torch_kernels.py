"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held here against the Pallas kernels in interpret mode and against their
jnp and numpy references, on the shapes of tests/test_kernels.py.  The
CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import numpy as np
import pytest
import torch

from repro.core.fastpath import sequential_mean, utility_matrix
from repro.kernels.knn.ops import knn_class_votes, knn_topk
from repro.kernels.utility.ops import utility_scores as pallas_utility_scores
from repro_torch.device import resolve_device
from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.utility import ops as util_ops

PENALTIES = ["step", "linear", "sigmoid", "none"]
KNN_SHAPES = [(16, 256, 8, 5, 3), (37, 700, 16, 1, 4), (128, 512, 32, 8, 6), (5, 40, 4, 5, 2)]
UTILITY_SHAPES = [(7, 3), (64, 5), (300, 8)]


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
