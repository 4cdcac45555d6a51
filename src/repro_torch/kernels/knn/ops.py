"""Wrapper of the k-NN evidence kernel (K2), the port of
``repro.kernels.knn.ops``.

Tensors on the CPU take the plain version (``ref.py``); CUDA tensors
launch ``csrc/knn.cu`` on the current stream, or raise.  There is no
other route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LaunchCounter, nvcc
from repro_torch.kernels.knn.ref import knn_topk_ref, votes_from_labels

__all__ = ["knn_topk", "knn_class_votes", "counter", "MAX_K", "MAX_DIM"]

counter = LaunchCounter("knn_topk")

MAX_K = 16  # the kernel keeps the top k in registers
MAX_DIM = 200  # the staged tile of training rows must fit in shared memory

_P = ctypes.c_void_p
_I = ctypes.c_int


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
    lib = nvcc.library("knn")
    lib.knn_slice_count.argtypes = [_I, _I, _I, _I]
    lib.knn_slice_count.restype = _I
    fn = lib.knn_topk_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
    slices = lib.knn_slice_count(q, n, k, sms)
    part_d = part_i = None
    if slices > 1:  # per-slice top-k lists, merged by a second kernel
        part_d = torch.empty((q, slices, k), dtype=torch.float32, device=queries.device)
        part_i = torch.empty((q, slices, k), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = fn(queries.data_ptr(), train_x.data_ptr(), train_norms.data_ptr(),
                 train_y.data_ptr(), dists.data_ptr(), labels.data_ptr(),
                 None if part_d is None else part_d.data_ptr(),
                 None if part_i is None else part_i.data_ptr(),
                 q, n, d, k, slices, stream)
    counter.add()
    nvcc.check(lib, err, "knn_topk")
    return dists, labels


def knn_class_votes(queries, train_x, train_norms, train_y, k: int, num_classes: int):
    """(Q, num_classes) float64 k-NN vote counts (SneakPeek evidence)."""
    _, labels = knn_topk(queries, train_x, train_norms, train_y, k)
    return votes_from_labels(labels, num_classes)
