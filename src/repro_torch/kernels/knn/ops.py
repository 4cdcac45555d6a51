"""Wrapper of the k-NN evidence kernel (K2), the port of
``repro.kernels.knn.ops``.

Tensors on the CPU take the plain version (``ref.py``); CUDA tensors
launch ``csrc/knn.cu`` on the current stream, or raise.  There is no
other route.  ``knn_plan`` computes the launch plan (query tile, stages
of the staged training tiles, slices of the training set, shared
memory) from the shapes and the SM count; the C entry validates it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import GRADIENTS_RULE, LaunchCounter, nvcc, refuse_grad
from repro_torch.kernels.knn.ref import knn_topk_ref, votes_from_labels

__all__ = ["knn_topk", "knn_class_votes", "knn_plan", "KnnPlan", "counter", "MAX_K", "MAX_DIM"]

counter = LaunchCounter("knn_topk")

MAX_K = 16  # the slice merge keeps the k best of each lane in registers
MAX_DIM = 200  # the query tile and two staged training tiles must fit in shared memory

TILE_ROWS = 64  # training rows per staged tile (16 row lanes x 4 rows)
SMEM_PER_BLOCK = 232_448  # 227 KB: the most a block may use on the H100
SMEM_PER_SM = 233_472  # 228 KB per SM, 1 KB of it reserved per resident block

_P = ctypes.c_void_p
_I = ctypes.c_int


def _row_stride(d: int) -> int:
    """Floats between two rows in shared memory: D in whole float4s, an
    odd number of them (csrc/knn.cu ``row_stride``)."""
    dp = (d + 3) // 4 * 4
    return dp if (dp // 4) % 2 else dp + 4


def knn_smem_bytes(query_tile: int, d: int, stages: int, k: int) -> int:
    """Shared bytes of the search kernel (csrc/knn.cu ``smem_bytes``): the
    queries, the staged tiles and their norms, and per query a tile's
    candidates, its sorted list, threshold and count."""
    s = _row_stride(d)
    return 4 * (query_tile * s + stages * TILE_ROWS * (s + 1)
                + query_tile * (2 * TILE_ROWS + 2 * k + 3))


@dataclasses.dataclass(frozen=True)
class KnnPlan:
    """One launch of the search: ``query_tile`` queries per block,
    ``stages`` staged training tiles, ``slices`` slices of
    ``slice_rows`` training rows (the last one shorter), and the shared
    bytes a block uses."""

    query_tile: int
    stages: int
    slices: int
    slice_rows: int
    smem_bytes: int

    def slice_bounds(self, n: int) -> list[tuple[int, int]]:
        """[lo, hi) training rows of each slice."""
        return [(s * self.slice_rows, min(n, (s + 1) * self.slice_rows))
                for s in range(self.slices)]

    def grid(self, q: int) -> tuple[int, int]:
        """(query blocks, slices)."""
        return (-(-q // self.query_tile), self.slices)


def knn_plan(q: int, n: int, d: int, k: int, sms: int) -> KnnPlan:
    """The launch plan of Q queries against N training rows of D features.

    The query tile is 128 (64 for at most 64 queries, or where 128 does
    not fit); the stages are as many (3 or 2) as leave two blocks on an
    SM, else as fit one.  The training set is cut into whole tiles so
    that the grid holds about two blocks per SM: at least one per SM
    wherever the query blocks times the tiles allow it, and no empty
    slice.
    """
    if q < 1 or n < 1 or not 1 <= d <= MAX_DIM or not 1 <= k <= min(MAX_K, n) or sms < 1:
        raise ValueError(f"no k-NN plan for Q={q} N={n} D={d} k={k} on {sms} SMs")
    for tile in ((128, 64) if q > 64 else (64,)):
        fits = [(st, knn_smem_bytes(tile, d, st, k)) for st in (3, 2)]
        fits = [(st, b) for st, b in fits if b <= SMEM_PER_BLOCK]
        if fits:
            two = [(st, b) for st, b in fits if 2 * (b + 1024) <= SMEM_PER_SM]
            stages, smem = (two or fits)[0]
            break
    else:  # unreachable for D <= MAX_DIM and k <= MAX_K
        raise ValueError(f"the k-NN kernel's shared memory cannot hold D={d}, k={k}")
    qblocks = -(-q // tile)
    tiles = -(-n // TILE_ROWS)
    target = min(tiles, -(-2 * sms // qblocks))
    per_slice = -(-tiles // target)  # tiles per slice
    return KnnPlan(tile, stages, -(-tiles // per_slice), per_slice * TILE_ROWS, smem)


def _check_args(queries, train_x, train_norms, train_y, k):
    if queries.ndim != 2 or train_x.ndim != 2 or queries.shape[1] != train_x.shape[1]:
        raise ValueError(
            f"queries (Q, D) and train_x (N, D) disagree: {tuple(queries.shape)} "
            f"vs {tuple(train_x.shape)}"
        )
    n = train_x.shape[0]
    if train_norms.shape != (n,) or train_y.shape != (n,):
        raise ValueError("train_norms and train_y must be (N,)")
    for name, t in (("queries", queries), ("train_x", train_x), ("train_norms", train_norms)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if train_y.dtype != torch.int32:
        raise TypeError(f"train_y must be int32, got {train_y.dtype}")
    for name, t in (("train_x", train_x), ("train_norms", train_norms), ("train_y", train_y)):
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on {queries.device}")
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, N={n}], got {k}")


def knn_topk(queries, train_x, train_norms, train_y, k: int):
    """(dists (Q, k) float32, labels (Q, k) int32): the k nearest training
    points of each query by ``|x|^2 - 2 q.x``, ascending, ties to the
    lower training index.  ``train_norms`` is ``|x|^2`` per row."""
    _check_args(queries, train_x, train_norms, train_y, k)
    if queries.device.type == "cpu":
        return knn_topk_ref(queries, train_x, train_norms, train_y, k)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_topk runs on CUDA or the CPU, not {queries.device}")
    if k > MAX_K:
        raise ValueError(f"the k-NN kernel takes k <= {MAX_K}, got {k}")
    q, d = queries.shape
    if d > MAX_DIM:
        raise ValueError(f"the k-NN kernel takes D <= {MAX_DIM}, got {d}")
    for name, t in (("queries", queries), ("train_x", train_x),
                    ("train_norms", train_norms), ("train_y", train_y)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dists = torch.empty((q, k), dtype=torch.float32, device=queries.device)
    labels = torch.empty((q, k), dtype=torch.int32, device=queries.device)
    if q == 0:
        return dists, labels
    n = train_x.shape[0]
    sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
    plan = knn_plan(q, n, d, k, sms)
    lib = nvcc.library("knn")
    fn = lib.knn_topk_f32
    fn.argtypes = [_P] * 8 + [_I] * 8 + [ctypes.c_longlong, _P]
    fn.restype = _I
    part_d = part_i = None
    if plan.slices > 1:  # per-slice top-k lists, merged by a second kernel
        part_d = torch.empty((q, plan.slices, k), dtype=torch.float32, device=queries.device)
        part_i = torch.empty((q, plan.slices, k), dtype=torch.int32, device=queries.device)
    refuse_grad("knn_topk", f"it has no backward ({GRADIENTS_RULE})", queries, train_x)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = fn(queries.data_ptr(), train_x.data_ptr(), train_norms.data_ptr(),
                 train_y.data_ptr(), dists.data_ptr(), labels.data_ptr(),
                 None if part_d is None else part_d.data_ptr(),
                 None if part_i is None else part_i.data_ptr(),
                 q, n, d, k, plan.query_tile, plan.stages, plan.slices, plan.slice_rows,
                 plan.smem_bytes, stream)
    counter.add()
    nvcc.check(lib, err, "knn_topk")
    return dists, labels


def knn_class_votes(queries, train_x, train_norms, train_y, k: int, num_classes: int):
    """(Q, num_classes) float64 k-NN vote counts (SneakPeek evidence)."""
    _, labels = knn_topk(queries, train_x, train_norms, train_y, k)
    return votes_from_labels(labels, num_classes)
